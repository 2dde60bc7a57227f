"""The port's metrics registry (`corrosion_tpu_torch.metrics`) against
the JAX package's (`corrosion_tpu.metrics`): the same sequence of
counter, gauge and histogram calls renders the same Prometheus text, and
a family asked for under another kind raises TypeError on both."""

import pytest

from corrosion_tpu import metrics as jax_metrics
from corrosion_tpu_torch import metrics as port_metrics

#: labels whose values need escaping: a quote, a backslash, a newline
ODD = {"path": 'a"b', "node": "c\\d", "note": "line\nbreak"}

#: (family kind, name, method, args, labels, histogram buckets)
CASES = {
    "counters": [
        ("counter", "c_total", "inc", (), {}, None),
        ("counter", "c_total", "inc", (3,), {}, None),
        ("counter", "c_total", "inc", (2.5,), {}, None),
        ("counter", "c_total", "inc", (7,), {"path": "sync"}, None),
        ("counter", "c_total", "inc", (1e-3,), ODD, None),
        ("counter", "never_total", None, (), {}, None),
        ("counter", "big_total", "inc", (11793075273728.0,), {}, None),
    ],
    "gauges": [
        ("gauge", "g", "set", (4,), {}, None),
        ("gauge", "g", "set", (0.1,), {"run": "x"}, None),
        ("gauge", "g", "add", (2.25,), {"run": "x"}, None),
        ("gauge", "g_inf", "set", (float("inf"),), ODD, None),
        ("gauge", "g_neg", "add", (-3,), {}, None),
        ("gauge", "g_unset", None, (), {}, None),
    ],
    "histograms": [
        ("histogram", "h_default", "observe", (0.003,), {}, None),
        ("histogram", "h_default", "observe", (0.5,), {}, None),
        ("histogram", "h_default", "observe", (120.0,), {"run": "b"}, None),
        ("histogram", "h_rounds", "observe", (16.0,),
         {}, (64, 1, 4, 16, 2)),
        ("histogram", "h_rounds", "observe", (3,), ODD, (64, 1, 4, 16, 2)),
        ("histogram", "h_latency", "observe", (0.0002,), {},
         "LATENCY_BUCKETS"),
        ("histogram", "h_empty", None, (), {}, None),
    ],
}
CASES["mixed"] = CASES["histograms"] + CASES["counters"] + CASES["gauges"]


def _apply(mod, ops):
    reg = mod.Registry()
    for kind, name, method, args, labels, buckets in ops:
        if kind == "histogram":
            if buckets == "LATENCY_BUCKETS":
                buckets = mod.LATENCY_BUCKETS
            fam = (reg.histogram(name) if buckets is None
                   else reg.histogram(name, buckets=buckets))
        else:
            fam = getattr(reg, kind)(name)
        if method is not None:
            getattr(fam, method)(*args, **labels)
    return reg


@pytest.mark.parametrize("case", sorted(CASES) + ["type-clash"])
def test_registry_renders_as_jax(case):
    if case == "type-clash":
        regs = [mod.Registry() for mod in (jax_metrics, port_metrics)]
        for reg in regs:
            reg.counter("x_total").inc(2)
            with pytest.raises(TypeError, match="x_total is Counter"):
                reg.gauge("x_total")
            reg.histogram("h").observe(1.0)
            with pytest.raises(TypeError, match="h is Histogram"):
                reg.counter("h")
        want, got = (reg.render() for reg in regs)
    else:
        want = _apply(jax_metrics, CASES[case]).render()
        got = _apply(port_metrics, CASES[case]).render()
    assert got == want
    assert got.endswith("\n") and "# TYPE" in got
