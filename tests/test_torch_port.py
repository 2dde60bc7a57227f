"""Package rules of the PyTorch/CUDA port: it imports nothing of JAX or
of the JAX package, its entry points refuse to drift to the CPU, its
wrappers check what reaches C, each CUDA source names the JAX function
it replaces at the right line, and a built library's name follows every
header its source includes."""

import ast
import re
import shutil
from pathlib import Path

import pytest
import torch

from corrosion_tpu_torch.device import resolve_device
from corrosion_tpu_torch.kernels import build
from corrosion_tpu_torch.kernels.build import CSRC, SOURCES, check
from corrosion_tpu_torch.cli import main as cli
from corrosion_tpu_torch.sim.runner import (
    config_broadcast_1k,
    config_fault_campaign_3node,
    config_gapstress_distortion,
    config_ground_truth_3node,
    config_packed_fault_storm,
    config_partition_heal_10k,
    config_storm_ab,
    config_swim_churn_64,
    config_swim_churn_partial,
    config_write_storm_100k,
    config_write_storm_gapstress,
    membership_churn,
)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "corrosion_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES]
)
def test_port_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "corrosion_tpu"), (
            f"{path.relative_to(ROOT)} imports {mod}"
        )


def test_entry_points_refuse_cuda_without_card():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    for entry in (config_write_storm_100k, config_packed_fault_storm,
                  config_storm_ab):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(n_nodes=512, n_payloads=256)  # default cuda
    for entry, kw in ((config_ground_truth_3node, {}),
                      (config_fault_campaign_3node, {}),
                      (config_broadcast_1k, {}),
                      (config_partition_heal_10k, {}),
                      (membership_churn, dict(n_nodes=64)),
                      (config_swim_churn_64, {}),
                      (config_swim_churn_partial, dict(n=64)),
                      (config_write_storm_gapstress, dict(n_nodes=64)),
                      (config_gapstress_distortion, dict(n_nodes=64))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(**kw)  # default cuda


@pytest.mark.parametrize("argv", [
    ["sim", "ground-truth-3node"],
    ["sim", "storm-ab", "--nodes", "512"],
    ["sim", "campaign", "run", "--spec", "fault-parity-3node"],
], ids=["scenario", "storm-ab", "campaign"])
def test_cli_defaults_to_the_card(argv, capsys, tmp_path, monkeypatch):
    """The command line's runs default to ``--device cuda``: without a
    card they exit 1 with the device error, never on the CPU."""
    if torch.cuda.is_available():
        assert cli.build_parser().parse_args(argv).device == "cuda"
        return
    monkeypatch.chdir(tmp_path)
    assert cli.main(argv) == 1
    out, err = capsys.readouterr()
    assert out == "" and "device='cpu'" in err
    assert list(tmp_path.iterdir()) == []  # no campaign artifact either


def test_wrapper_check_refuses_what_c_cannot_take():
    x = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        check("x", x, torch.int32, (4, 8))


@pytest.mark.parametrize("source", SOURCES)
def test_cuda_source_names_the_jax_function_it_replaces(source):
    head = (CSRC / source).read_text()[:2000]
    m = re.search(
        r"corrosion_tpu/(sim|topo)/(\w+\.py):(\d+)\s+(?://\s*)?(\w+)", head)
    assert m, f"{source} does not name the JAX function it replaces"
    jax_file = ROOT / "corrosion_tpu" / m.group(1) / m.group(2)
    line = jax_file.read_text().splitlines()[int(m.group(3)) - 1]
    assert line.startswith(f"def {m.group(4)}("), (source, line)


LANE_SOURCES = ("threefry.cu", "sample_targets.cu", "broadcast_scatter.cu",
                "sync_pull.cu", "gaps_refresh.cu", "converge_fold.cu",
                "word_phases.cu", "fault_edges.cu", "node_faults.cu",
                "dense_phases.cu", "dense_sync.cu", "dense_gaps.cu",
                "swim_full.cu", "membership_detect.cu")


@pytest.mark.parametrize("source", LANE_SOURCES)
def test_lane_note_names_the_ensemble(source):
    """A source with a lane entry names the JAX ensemble it batches for,
    each mention at the line of its def (``run_ensemble``, or for the
    detect loop's lanes ``run_detect_ensemble``)."""
    text = (CSRC / source).read_text()
    found = re.findall(r"corrosion_tpu/campaign/\s*ensemble\.py:(\d+)",
                       text)
    assert found, f"{source} does not name campaign/ensemble.py"
    lines = (ROOT / "corrosion_tpu" / "campaign" / "ensemble.py").read_text(
    ).splitlines()
    for number in found:
        line = lines[int(number) - 1]
        assert line.startswith(("def run_ensemble(",
                                "def run_detect_ensemble(")), (source, line)


def test_library_name_follows_included_headers(tmp_path):
    """An edit to a header a source includes, directly or through another
    header, renames the source's library, so a stale build never loads;
    an edit to an unrelated file does not."""
    shutil.copytree(CSRC, tmp_path, dirs_exist_ok=True)
    assert build.local_includes("threefry.cu", tmp_path) == ["threefry.cuh"]
    before = build._lib_path("threefry.cu", tmp_path)
    assert before == build._lib_path("threefry.cu")  # same bytes, same name
    header = tmp_path / "threefry.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = build._lib_path("threefry.cu", tmp_path)
    assert edited != before

    (tmp_path / "inner.cuh").write_text("#pragma once\n")
    header.write_text(header.read_text() + '#include "inner.cuh"\n')
    assert build.local_includes("threefry.cu", tmp_path) == [
        "inner.cuh", "threefry.cuh"]
    nested = build._lib_path("threefry.cu", tmp_path)
    (tmp_path / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert build._lib_path("threefry.cu", tmp_path) != nested

    other = build._lib_path("sync_pull.cu", tmp_path)
    header.write_text(header.read_text() + "// again\n")
    assert build._lib_path("sync_pull.cu", tmp_path) == other


@pytest.mark.parametrize("source", SOURCES)
def test_cuda_source_includes_exist(source):
    for name in build.local_includes(source):
        assert (CSRC / name).is_file(), (source, name)
