"""The port's analytic counts against ``repro``'s: ``param_counts`` and
``model_flops`` (``repro_torch.models.flops``) give the same dict, exactly,
for every architecture id, at its full and its smoke config, at every
``SHAPES`` entry that ``shape_applicable`` allows and at the three
``smoke_shape`` kinds; ``lm_task_work`` (``repro_torch.fl.pilot``) gives the
same float.  Integer arithmetic on both sides: no tolerance.
"""

import dataclasses

import pytest

from repro import shapes as repro_shapes
from repro.configs import get_config as repro_get_config
from repro.configs import get_smoke_config as repro_get_smoke_config
from repro.fl.pilot import lm_task_work as repro_lm_task_work
from repro.models import model_flops as repro_model_flops
from repro.models import param_counts as repro_param_counts
from repro_torch import shapes
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.fl.pilot import lm_task_work
from repro_torch.models import model_flops, param_counts

SIZES = ("full", "smoke")
SMOKE_KINDS = ("train", "prefill", "decode")


def _configs(arch: str, size: str):
    if size == "smoke":
        return repro_get_smoke_config(arch), get_smoke_config(arch)
    return repro_get_config(arch), get_config(arch)


def _spec_cases():
    """(arch, size, shape name or smoke kind) for every applicable shape."""
    out = []
    for arch in ARCH_IDS:
        names = [n for n in repro_shapes.SHAPES if repro_shapes.shape_applicable(arch, n)]
        out += [(arch, size, n) for size in SIZES for n in names + [f"smoke_{k}" for k in
                                                                     SMOKE_KINDS]]
    return out


def _specs(name: str):
    if name.startswith("smoke_"):
        kind = name.removeprefix("smoke_")
        return repro_shapes.smoke_shape(kind), shapes.smoke_shape(kind)
    return repro_shapes.SHAPES[name], shapes.SHAPES[name]


def test_registry_and_shapes_match_repro():
    from repro.configs import ARCH_IDS as REPRO_IDS

    assert set(ARCH_IDS) == set(REPRO_IDS)
    assert {n: dataclasses.asdict(s) for n, s in shapes.SHAPES.items()} == {
        n: dataclasses.asdict(s) for n, s in repro_shapes.SHAPES.items()}
    for arch in ARCH_IDS:
        for name in shapes.SHAPES:
            assert shapes.shape_applicable(arch, name) == repro_shapes.shape_applicable(arch,
                                                                                       name)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("size", SIZES)
def test_param_counts_match_repro(arch, size):
    rcfg, cfg = _configs(arch, size)
    got, want = param_counts(cfg), repro_param_counts(rcfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert all(type(v) is int for v in dataclasses.asdict(got).values())


@pytest.mark.parametrize("arch,size,shape", _spec_cases())
def test_model_flops_match_repro(arch, size, shape):
    rcfg, cfg = _configs(arch, size)
    rspec, spec = _specs(shape)
    assert dataclasses.asdict(spec) == dataclasses.asdict(rspec)
    got, want = model_flops(cfg, spec), repro_model_flops(rcfg, rspec)
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in want.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("size", SIZES)
def test_lm_task_work_matches_repro(arch, size):
    rcfg, cfg = _configs(arch, size)
    for local_steps, tokens in ((1, 4096), (5, 2 * 4096), (2, 128)):
        got = lm_task_work(cfg, local_steps, tokens)
        assert got == repro_lm_task_work(rcfg, local_steps, tokens)
        assert got == 6.0 * param_counts(cfg).active * tokens * local_steps
