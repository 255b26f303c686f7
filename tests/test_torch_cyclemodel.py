"""PyTorch port: the cycle model and the paper's constants against the JAX
package's (``repro/core/cyclemodel.py``, ``repro/core/policy.py``).

The model is plain Python float arithmetic kept in the reference's
operation order, so every number must be EQUAL (``==``, tolerance 0) to
JAX's: every network, design, profile and layer kind of
``network_speedup``, ``geomean_speedup``, ``efficiency``,
``scaling_curve``, and the three cycle laws on every layer. The paper
checks of ``tests/test_cyclemodel.py`` are repeated on the port at their
own tolerances (5% where the model has no free parameter, 16% on LM
CVLs).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import itertools
import math

import numpy as np
import pytest
import torch

from repro.core import cyclemodel as jcm, policy as jP
from repro_torch.core import cyclemodel as cm, policy as P

_CONSTANTS = ("TABLE1_CVL_ACT_100", "TABLE1_CVL_ACT_99", "TABLE1_CVL_W_100",
              "TABLE1_CVL_W_99", "TABLE1_FCL_W_100", "TABLE1_FCL_W_99",
              "TABLE3_EFFECTIVE_W", "PAPER_GEOMEANS", "PAPER_PER_NETWORK",
              "RELATIVE_POWER", "RELATIVE_AREA")
_DIMS = ("N_LANES", "K_FILTERS", "SIP_ROWS", "SIP_COLS", "BASE_BITS",
         "DYN_RATIO")
_PROFILES = ("100", "99", "t3")
_KINDS = ("all", "cvl", "fcl")


@pytest.mark.parametrize("name", _CONSTANTS)
def test_paper_constants_equal_the_reference(name):
    assert getattr(P, name) == getattr(jP, name)


def test_networks_designs_and_dims_equal_the_reference():
    assert list(cm.NETWORKS) == list(jcm.NETWORKS)
    for name, net in cm.NETWORKS.items():
        ref = jcm.NETWORKS[name]
        assert net.name == ref.name
        assert [tuple(vars(l).values()) for l in net.layers] == \
            [tuple(vars(l).values()) for l in ref.layers]
    assert {k: vars(d) for k, d in cm.DESIGNS.items()} == \
        {k: vars(d) for k, d in jcm.DESIGNS.items()}
    assert [getattr(cm, d) for d in _DIMS] == [getattr(jcm, d) for d in _DIMS]


@pytest.mark.parametrize("net", sorted(jcm.NETWORKS))
def test_network_speedup_equals_the_reference(net):
    for design, profile, kind in itertools.product(
            jcm.DESIGNS, _PROFILES, _KINDS):
        got = cm.network_speedup(net, design, profile, kind)
        want = jcm.network_speedup(net, design, profile, kind)
        assert got == want or (math.isnan(got) and math.isnan(want)), \
            (net, design, profile, kind, got, want)


@pytest.mark.parametrize("design", sorted(jcm.DESIGNS))
def test_geomean_efficiency_and_scaling_curve_equal_the_reference(design):
    for profile, kind in itertools.product(_PROFILES, _KINDS):
        got = cm.geomean_speedup(design, profile, kind)
        assert got == jcm.geomean_speedup(design, profile, kind)
        assert cm.efficiency(design, got) == jcm.efficiency(design, got)
    before = ([getattr(cm, d) for d in _DIMS], [getattr(jcm, d) for d in _DIMS])
    for profile in _PROFILES:
        curve = cm.scaling_curve(design, profile)
        assert list(curve) == [32, 64, 128, 256, 512]
        assert curve == jcm.scaling_curve(design, profile), (design, profile)
    # Both modules' globals are restored, and the curve moved: the port
    # patched its own dimensions, not the reference's.
    assert ([getattr(cm, d) for d in _DIMS],
            [getattr(jcm, d) for d in _DIMS]) == before
    assert len(set(cm.scaling_curve(design, "100").values())) > 1


def test_scaling_curve_restores_its_globals_when_a_point_raises(monkeypatch):
    saved = [getattr(cm, d) for d in _DIMS]

    def boom(*args):
        assert (cm.K_FILTERS, cm.SIP_ROWS) == (2, 32)   # the 32-MAC point
        raise RuntimeError("planted")
    monkeypatch.setattr(cm, "network_speedup", boom)
    with pytest.raises(RuntimeError, match="planted"):
        cm.scaling_curve("lm1b")
    assert [getattr(cm, d) for d in _DIMS] == saved


def _all_layers():
    return [(n, i) for n, net in jcm.NETWORKS.items()
            for i in range(len(net.layers))]


@pytest.mark.parametrize("net", sorted(jcm.NETWORKS))
def test_cycle_laws_equal_the_reference_on_every_layer(net):
    for tl, jl in zip(cm.NETWORKS[net].layers, jcm.NETWORKS[net].layers):
        assert cm.dpnn_cycles(tl) == jcm.dpnn_cycles(jl)
        for pa in (1, 5, 8, 13, 16):
            assert cm.stripes_cycles(tl, pa) == jcm.stripes_cycles(jl, pa)
        for pa, pw, b, dyn in itertools.product(
                (3, 8.5, 16), (1, 7, 11.25, 16), (1, 2, 4), (False, True)):
            assert cm.lm_cycles(tl, pa, pw, b, dyn) == \
                jcm.lm_cycles(jl, pa, pw, b, dyn), (tl.name, pa, pw, b, dyn)


@pytest.mark.parametrize("kind", ["list", "numpy", "tensor"])
def test_lm_cycles_with_pw_groups_equals_the_reference(kind):
    rng = np.random.default_rng(7)
    counts = rng.integers(1, 17, size=24).astype(np.int32)
    groups = {"list": counts.tolist(), "numpy": counts,
              "tensor": torch.from_numpy(counts)}[kind]
    for (net, i) in _all_layers()[::5]:
        tl, jl = cm.NETWORKS[net].layers[i], jcm.NETWORKS[net].layers[i]
        for b in (1, 2, 4):
            got = cm.lm_cycles(tl, 8, 16, b, pw_groups=groups)
            assert got == jcm.lm_cycles(jl, 8, 16, b, pw_groups=counts)
            assert got == cm.lm_cycles(tl, 8, float(counts.mean()), b)
    # An empty group list keeps the layer's own Pw, in both packages.
    l0 = cm.NETWORKS["alexnet"].layers[0]
    assert cm.lm_cycles(l0, 8, 11, pw_groups=[]) == \
        jcm.lm_cycles(jcm.NETWORKS["alexnet"].layers[0], 8, 11, pw_groups=[])


# -- the paper checks of tests/test_cyclemodel.py, on the port ---------------

TIGHT = 0.05   # Stripes + FCLs: no free parameters
LOOSE = 0.16   # LM CVLs: global dynamic-trim ratio vs per-network reality


@pytest.mark.parametrize("key", sorted(P.PAPER_GEOMEANS))
def test_port_geomean_speedups_vs_paper(key):
    profile, kind, design = key
    paper_perf, paper_eff = P.PAPER_GEOMEANS[key]
    perf = cm.geomean_speedup(design, profile, kind)
    tol = TIGHT if (design == "stripes" or kind == "fcl") else LOOSE
    assert abs(perf / paper_perf - 1) < tol, (key, perf, paper_perf)
    eff = cm.efficiency(design, perf)
    assert abs(eff / paper_eff - 1) < tol + 0.02, (key, eff, paper_eff)


def test_port_abstract_headline_claims():
    perf = cm.geomean_speedup("lm1b", "t3", "all")
    assert abs(perf / 4.38 - 1) < 0.05
    assert abs(cm.efficiency("lm1b", perf) / 3.54 - 1) < 0.05


def test_port_cycle_laws_and_cascading():
    fc = cm.Layer("fc", "fcl", 4096 * 4096, 4096)
    for pw in (4, 8, 10, 16):
        s = cm.dpnn_cycles(fc) / cm.lm_cycles(fc, 16, pw)
        assert abs(s - 16 / pw) < 0.02 * (16 / pw), (pw, s)
    conv = cm.Layer("c", "cvl", 512 * 4608 * 28 * 28, 512, 28 * 28)
    for pa, pw in ((8, 8), (5, 11), (16, 16)):
        s = cm.dpnn_cycles(conv) / cm.lm_cycles(conv, pa, pw, dynamic_a=False)
        assert abs(s - 256 / (pa * pw)) < 0.02 * (256 / (pa * pw)), (pa, pw)
    small = cm.Layer("fc", "fcl", 1000 * 1024, 1000)
    assert 2.0 < cm.dpnn_cycles(small) / cm.lm_cycles(small, 16, 7) < 2.35
    fc6 = cm.Layer("fc", "fcl", 4096 * 9216, 4096)
    s1, s2, s4 = (cm.dpnn_cycles(fc6) / cm.lm_cycles(fc6, 16, 9, b)
                  for b in (1, 2, 4))
    assert abs(s2 / s1 - 1) < 0.02 and abs(s4 / s1 - 1) < 0.02
    c = cm.Layer("c", "cvl", 256 * 2304 * 28 * 28, 256, 28 * 28)
    assert abs(cm.lm_cycles(c, 8, 11, 4, dynamic_a=False)
               / cm.lm_cycles(c, 5, 11, 4, dynamic_a=False) - 1.0) < 1e-9
    assert abs(cm.lm_cycles(c, 8, 11, 1, dynamic_a=False)
               / cm.lm_cycles(c, 5, 11, 1, dynamic_a=False) - 1.6) < 1e-9


def test_port_scaling_curve_shape():
    curve = cm.scaling_curve("lm1b", "100")
    assert curve[32] >= curve[128] >= curve[256] >= curve[512]
    assert curve[128] > 2.5
