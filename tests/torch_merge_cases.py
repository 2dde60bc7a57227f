"""The branch cases of K4's function, the partial-view SWIM table merge:
one case per branch of JAX ``_merge_entries`` (corrosion_tpu/sim/pswim.py
:141-173), each built so that its branch decides a known cell, with a
check that the branch fired.  No JAX here: the CPU test holds the port's
plain version against live JAX on these cases
(tests/test_torch_merge_branches.py), the card's test the kernel against
the plain version (tests/test_torch_kernels_cuda.py)."""

import numpy as np

N, M, T, GC = 300, 16, 50, 12
ALIVE, SUSPECT, DOWN = 0, 1, 2


def _random_tables(g):
    """Member tables as a long run leaves them: residue-mapped ids with
    -1 empties, keys across ALIVE/SUSPECT/DOWN with incarnations up to
    the clamp (packed words then carry bit 31), psince stamps up to T."""
    ids = np.arange(M)[None, :] + M * g.integers(0, (N + M - 1) // M, (N, M))
    pid = np.where((ids < N) & (g.random((N, M)) > 0.15), ids, -1)
    inc = np.where(g.random((N, M)) < 0.2, g.integers(1024, 2047, (N, M)),
                   g.integers(0, 4, (N, M)))
    pkey = np.where(pid >= 0, inc * 4 + g.integers(0, 3, (N, M)), -1)
    psince = np.where(g.random((N, M)) < 0.5, g.integers(0, T + 1, (N, M)),
                      -1)
    return (pid.astype(np.int32), pkey.astype(np.int32),
            psince.astype(np.int32))


def _base(seed):
    """Tables as a long run leaves them, plus background entries that
    crowd other receivers (so each case's cell sits among live merges)."""
    g = np.random.default_rng(seed)
    pid, pkey, psince = _random_tables(g)
    e = 2000
    e_dst = g.integers(N // 2, N, e)
    picked = pid[e_dst, g.integers(0, M, e)]
    e_id = np.where((g.random(e) < 0.5) & (picked >= 0), picked,
                    g.integers(0, N, e))
    e_key = g.integers(0, 2047, e) * 4 + g.integers(0, 3, e)
    e_ok = g.random(e) < 0.85
    return [pid, pkey, psince], [e_dst, e_id, e_key, e_ok]


def _add(ent, dst, ids, keys, ok=True):
    """Append entries to the [dst, id, key, ok] lists (broadcast)."""
    ids = np.atleast_1d(ids)
    keys = np.broadcast_to(keys, ids.shape)
    extra = (np.full(ids.shape, dst), ids, keys, np.full(ids.shape, ok))
    return [np.concatenate([a, b]) for a, b in zip(ent, extra)]


def _case_non_alive_on_empty(tabs, ent):
    pid, pkey, psince = tabs
    dst, cand = 3, 5 * M + 7  # bucket 7
    pid[dst, 7], pkey[dst, 7], psince[dst, 7] = -1, -1, -1
    ent = _add(ent, dst, [cand, cand], [9 * 4 + SUSPECT, 3 * 4 + DOWN])

    def fired(old, new):
        # the bucket was empty, the claims were not ALIVE: it stays empty
        return all(x[dst, 7] == -1 for x in new)

    return ent, fired


def _case_young_down(tabs, ent):
    pid, pkey, psince = tabs
    dst, held, rival = 4, 2 * M + 5, 6 * M + 5  # bucket 5
    pid[dst, 5], pkey[dst, 5], psince[dst, 5] = held, 7 * 4 + DOWN, T - 3
    ent = _add(ent, dst, rival, 8 * 4 + ALIVE)

    def fired(old, new):
        # T - since = 3 < GC: the DOWN entry resists eviction
        return (new[0][dst, 5] == held and new[1][dst, 5] == 7 * 4 + DOWN
                and new[2][dst, 5] == T - 3)

    return ent, fired


def _case_aged_down_unstamped(tabs, ent):
    pid, pkey, psince = tabs
    dst, held, rival = 5, 1 * M + 9, 4 * M + 9  # bucket 9
    pid[dst, 9], pkey[dst, 9], psince[dst, 9] = held, 7 * 4 + DOWN, -1
    ent = _add(ent, dst, rival, 2 * 4 + ALIVE)

    def fired(old, new):
        # psince = -1 counts as aged: the ALIVE claim takes the bucket
        return (new[0][dst, 9] == rival and new[1][dst, 9] == 2 * 4 + ALIVE
                and new[2][dst, 9] == -1)

    return ent, fired


def _case_revival_beats_rival(tabs, ent):
    pid, pkey, psince = tabs
    dst, held, rival = 6, 3 * M + 11, 7 * M + 11  # bucket 11
    pid[dst, 11], pkey[dst, 11], psince[dst, 11] = held, 5 * 4 + DOWN, 1
    ent = _add(ent, dst, [rival, held], [9 * 4 + ALIVE, 6 * 4 + ALIVE])

    def fired(old, new):
        # the rival qualified on the pre-merge table (aged DOWN), but the
        # matching id's precedence revived the bucket, so the recheck
        # refuses the rival; the changed key clears the stamp
        return (new[0][dst, 11] == held and new[1][dst, 11] == 6 * 4 + ALIVE
                and new[2][dst, 11] == -1)

    return ent, fired


def _case_duplicates(tabs, ent):
    pid, pkey, psince = tabs
    dst, held = 7, 2 * M + 2  # bucket 2: precedence among duplicates
    pid[dst, 2], pkey[dst, 2], psince[dst, 2] = held, 1 * 4 + ALIVE, -1
    g = np.random.default_rng(7)
    keys = g.integers(2, 40, 50) * 4 + g.integers(0, 3, 50)
    ent = _add(ent, dst, np.full(50, held), keys)
    # bucket 3, empty: fifty ALIVE rivals, the largest (key, id) wins
    pid[dst, 3], pkey[dst, 3], psince[dst, 3] = -1, -1, -1
    rivals = M * g.integers(0, N // M, 50) + 3
    rkeys = g.integers(0, 30, 50) * 4
    ent = _add(ent, dst, rivals, rkeys)
    best = max(zip(rkeys, rivals))

    def fired(old, new):
        return (new[1][dst, 2] == keys.max()
                and (new[0][dst, 3], new[1][dst, 3]) == (best[1], best[0]))

    return ent, fired


def _case_none_ok(tabs, ent):
    ent = [ent[0], ent[1], ent[2], np.zeros_like(ent[3])]
    ent = _add(ent, 8, 3 * M + 1, 4 * ALIVE, ok=False)

    def fired(old, new):
        return all((a == b).all() for a, b in zip(old, new))

    return ent, fired


CASES = {
    "non_alive_on_empty": _case_non_alive_on_empty,
    "alive_on_young_down": _case_young_down,
    "alive_on_aged_down_unstamped": _case_aged_down_unstamped,
    "revival_beats_rival": _case_revival_beats_rival,
    "duplicates_max_wins": _case_duplicates,
    "no_entry_ok": _case_none_ok,
}


def build(case):
    """Case ``case``'s numpy inputs, (pid, pkey, psince, e_dst, e_id, e_key,
    e_ok), and its check ``fired(old_tables, new_tables)``."""
    tabs, ent = _base(sorted(CASES).index(case))
    ent, fired = CASES[case](tabs, ent)
    ent = [ent[0].astype(np.int32), ent[1].astype(np.int32),
           ent[2].astype(np.int32), ent[3].astype(bool)]
    return (*tabs, *ent), fired
