"""The rows a data-parallel rank trains on (``data.rank_rows``,
``launch.train.batch_rows``): its draw is its rows of the global batch,
``jit_train_step`` fed them trains bit for bit as it did on the global
batch, and the dry run's train cells hand each fake rank B / data rows.

* Over (data 2, accum 1 and 2), qwen3-1.7b and llama-3.2-vision-90b
  smoke (``img_embeds``): the ranks' draws of each microbatch, taken in
  rank order, equal the global ``synthetic_batch``'s rows; the global
  draw is the one the pipeline made before ranks drew their own.
* On (2, 1) and (2, 2) gloo worlds (``tests/_train_cli_ranks.py``'s rows
  checks): ``jit_train_step`` on the rank's rows against the rows the
  step cut from the global batch for itself (each microbatch's "dp"
  slice): the rows equal, two steps' loss and grad norm ``torch.equal``.
* The dry run's ``build_step`` for ``train_4k`` on the single- and
  multi-pod production meshes (a fake world, in a subprocess): every
  batch leaf holds ``256 / data`` rows.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _dist_ranks as R
from repro_torch import configs
from repro_torch.data import DataConfig, rank_rows, synthetic_batch
from repro_torch.data.pipeline import _rng_for

ARCHS = ("qwen3-1.7b", "llama-3.2-vision-90b")


def _dcfg(arch: str, batch: int = 8) -> DataConfig:
    cfg = configs.get(arch, smoke=True)
    return DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=batch,
                      n_img_tokens=cfg.n_img_tokens, d_model=cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("accum", [1, 2])
def test_ranks_draws_are_the_global_rows(arch, accum):
    dcfg = _dcfg(arch)
    whole = synthetic_batch(dcfg, 5)
    assert ("img_embeds" in whole) == (arch != "qwen3-1.7b")
    draws = [synthetic_batch(dcfg, 5, rank_rows(8, accum, 2, r))
             for r in range(2)]
    for k, v in whole.items():
        mbs = [np.split(d[k], accum) for d in draws]     # [rank][mb]
        got = np.concatenate([mbs[r][i] for i in range(accum)
                              for r in range(2)])
        assert got.dtype == v.dtype and np.array_equal(got, v), k


def test_rank_rows_layout():
    assert rank_rows(8, 1, 2, 1) == [4, 5, 6, 7]
    assert rank_rows(8, 2, 2, 1) == [2, 3, 6, 7]
    assert rank_rows(8, 2, 1, 0) == list(range(8))
    for batch, accum, n in ((3, 1, 2), (4, 4, 2), (6, 4, 1)):
        with pytest.raises(ValueError, match="equal microbatches"):
            rank_rows(batch, accum, n, 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_global_draw_is_unchanged(arch):
    """Token rows from each row's stream, image rows from row
    ``global_batch``'s stream in one draw, as before ranks drew rows."""
    from repro_torch.data.pipeline import _packed_row
    dcfg = _dcfg(arch)
    got = synthetic_batch(dcfg, 3)
    packed = np.stack([_packed_row(dcfg, 3, r) for r in range(8)])
    assert np.array_equal(got["tokens"], packed[:, :-1])
    assert np.array_equal(got["labels"], packed[:, 1:])
    if dcfg.n_img_tokens:
        want = _rng_for(dcfg, 3, 8).standard_normal(
            (8, dcfg.n_img_tokens, dcfg.d_model), dtype=np.float32)
        assert np.array_equal(got["img_embeds"], want)


MESHES = ((2, 1), (2, 2))
ROWS_CHECKS = ("rows_accum1", "rows_accum2")


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    started = {shape: R.start(shape, ROWS_CHECKS, str(
        tmp_path_factory.mktemp(f"rows{shape[0]}x{shape[1]}")),
        "_train_cli_ranks") for shape in MESHES}
    return {shape: R.collect(s)[0] for shape, s in started.items()}


@pytest.mark.parametrize("shape", MESHES, ids=["2x1", "2x2"])
@pytest.mark.parametrize("check", ROWS_CHECKS)
def test_step_on_rank_rows_equals_the_global_batch_form(mesh_results, shape,
                                                        check):
    got = mesh_results[shape][check]
    assert len(got) == shape[0] * shape[1]
    assert got == ["ok"] * len(got), "\n".join(r for r in got if r != "ok")


_DRYRUN_ROWS = r"""
import json
from repro_torch import configs
from repro_torch.dist import sharding
from repro_torch.dist.parallel import ShardCtx
from repro_torch.launch import dryrun, shapes
cell = shapes.SHAPES["train_4k"]
out = {}
for mk in ("single", "multi"):
    mesh = dryrun.production_mesh(mk)
    sharding.set_rule_overrides(dryrun.overrides_for(cell, mk))
    sh = ShardCtx(mesh)
    for arch in ("qwen3-1.7b", "llama-3.2-vision-90b"):
        _, args, _ = dryrun.build_step(configs.get(arch), cell, "dense",
                                       "dense", sh)
        out[f"{mk} {arch}"] = {"dp": sh.size("dp"), "leaves": {
            k: list(v.shape) for k, v in args[1].items()}}
    sharding.set_rule_overrides({})
print(json.dumps(out))
"""


def test_dryrun_train_cell_hands_each_rank_its_rows():
    r = subprocess.run([sys.executable, "-c", _DRYRUN_ROWS],
                       capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH="src"), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    vision = configs.get("llama-3.2-vision-90b")
    for mk, dp in (("single", 16), ("multi", 32)):
        for arch in ("qwen3-1.7b", "llama-3.2-vision-90b"):
            g = got[f"{mk} {arch}"]
            rows = 256 // dp
            want = {"tokens": [rows, 4096], "labels": [rows, 4096]}
            if arch != "qwen3-1.7b":
                want["img_embeds"] = [rows, vision.n_img_tokens,
                                      vision.d_model]
            assert g == {"dp": dp, "leaves": want}, (mk, arch, g)
