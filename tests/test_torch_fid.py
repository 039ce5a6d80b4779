"""Discriminator-feature FID: the port against the JAX package.

- sqrtm and FID math (ops/sqrtm.py, evalx/fid.calculate_fid_from_features)
  on the same numpy inputs, per method: `lowrank` and `scipy` are the same
  float64 host code (1e-10 relative); `newton_schulz` runs float32 matmuls
  (XLA on one side, torch on the CPU here) and agrees to 1e-4 relative.
- FIDEvaluator: the JAX evaluator pins `fid_tmp_init.pickle` over a small
  PNG folder (64x80, the smallest size with an 8x8 feature pool) and JAX
  exports of two generator epochs; the port's evaluator reads a copy of
  that pickle (`continue_=True`) and the same exports and gives the same
  per-batch FIDs within 1e-4 relative, with `quirk_range_mismatch` off and
  on. The generator has base width 512, because the JAX evaluator builds
  its generator at the config's default width and flax refuses other
  shapes; the exports hold port-initialized weights written by the JAX
  package's export_params.
- Resuming skips finished epochs, and an epoch removed from fids.pickle is
  computed again to the same values; the CLI wipes <out>/evaluation unless
  `-ct`, draws its plots and refuses `--inception`.
"""

import pickle
import shutil

import numpy as np
import pytest
import torch

from imagegeneration_tpu.core import checkpoint as jckpt
from imagegeneration_tpu.core import data as jdata
from imagegeneration_tpu.evalx import fid as jfid
from imagegeneration_tpu.ops import sqrtm as jsqrtm
from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.cli import generator_evaluation as tcli
from imagegeneration_tpu_torch.evalx import fid as tfid
from imagegeneration_tpu_torch.models import sndcgan as tmodels
from imagegeneration_tpu_torch.ops import sqrtm as tsqrtm

torch.set_num_threads(1)
CPU = torch.device("cpu")
H, W, BATCH = 64, 80, 4
METHOD_RTOL = {"lowrank": 1e-10, "scipy": 1e-10, "newton_schulz": 1e-4}
FID_RTOL = 1e-4


def _spd(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a @ a.T / n + np.eye(n)).astype(np.float32)


def test_sqrtm_newton_schulz_matches_jax():
    a = _spd(48, 0) @ _spd(48, 1)
    want = np.asarray(jsqrtm.sqrtm_newton_schulz(a))
    got = tsqrtm.sqrtm_newton_schulz(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("method", ["lowrank", "scipy", "newton_schulz"])
def test_fid_math_matches_jax(method):
    """Well-conditioned features (more samples than dimensions), so that
    every method applies."""
    rng = np.random.default_rng(1)
    fake = rng.standard_normal((96, 24)).astype(np.float32)
    real = (rng.standard_normal((96, 24)) * 1.3 + 0.2).astype(np.float32)
    want = jfid.calculate_fid_from_features(fake, real, method)
    got = tfid.calculate_fid_from_features(fake, real, method, device=CPU)
    assert got == pytest.approx(want, rel=METHOD_RTOL[method])
    if method != "lowrank":
        cov_f = np.cov(fake, rowvar=False).astype(np.float32)
        cov_r = np.cov(real, rowvar=False).astype(np.float32)
        assert tsqrtm.trace_sqrtm_product(cov_f, cov_r, method, device=CPU) == pytest.approx(
            jsqrtm.trace_sqrtm_product(cov_f, cov_r, method), rel=METHOD_RTOL[method])
    assert tsqrtm.trace_sqrtm_product_lowrank(fake, real) == pytest.approx(
        jsqrtm.trace_sqrtm_product_lowrank(fake, real), rel=1e-12)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A PNG folder (8 images) and the exports of one run: generator epochs
    1 and 2 (different weights), discriminator epoch 2."""
    import cv2

    root = tmp_path_factory.mktemp("fid")
    data = root / "data" / "landscape"
    data.mkdir(parents=True)
    rng = np.random.default_rng(5)
    for i in range(8):
        cv2.imwrite(str(data / f"i{i}.png"), rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    cfg = tmodels.SNDCGANConfig(image_size=(H, W, 3), dropout_rate=0.0)
    models = root / "train" / "models"
    for e in (1, 2):
        gen = tmodels.Generator(cfg, torch.Generator().manual_seed(10 + e))
        jckpt.export_params(models / "generator" / f"gen_model-{e}.msgpack",
                            bridge.export_variables(gen))
    disc = tmodels.Discriminator(cfg, torch.Generator().manual_seed(2))
    jckpt.export_params(models / "discriminator" / "disc_model-2.msgpack",
                        bridge.export_variables(disc))
    return root


@pytest.mark.parametrize("quirk", [False, True], ids=["fixed", "quirk"])
def test_evaluator_matches_jax_from_a_shared_pin(run_dir, tmp_path, quirk):
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jev = jfid.FIDEvaluator(str(run_dir / "train"), str(jax_out), image_size=(H, W, 3),
                            dropout=0.0, quirk_range_mismatch=quirk)
    ds = jdata.ImageFolderDataset(str(run_dir / "data"), (H, W), labeled=True)
    want = jev.evaluate(dataset=ds, batch_size=BATCH, start_epoch=0)
    port_out.mkdir()
    shutil.copy(jax_out / "fid_tmp_init.pickle", port_out / "fid_tmp_init.pickle")
    tev = tfid.FIDEvaluator(str(run_dir / "train"), str(port_out), image_size=(H, W, 3),
                            dropout=0.0, quirk_range_mismatch=quirk, device=CPU)
    got = tev.evaluate(continue_=True)
    assert sorted(got) == sorted(want) == [1, 2]
    for e in want:
        assert len(got[e]) == len(want[e]) == 2  # 8 images: 2 pinned batches of 4
        np.testing.assert_allclose(got[e], want[e], rtol=FID_RTOL, atol=0)


def test_resume_skips_done_epochs(run_dir, tmp_path):
    ev = tfid.FIDEvaluator(str(run_dir / "train"), str(tmp_path), image_size=(H, W, 3),
                           dropout=0.0, sqrtm_method="scipy", device=CPU)
    from imagegeneration_tpu_torch.core.data import ImageFolderDataset

    ds = ImageFolderDataset(run_dir / "data", (H, W))
    first = ev.evaluate(dataset=ds, batch_size=BATCH, start_epoch=0)
    assert sorted(first) == sorted(ev.epoch_seconds) == [1, 2]
    assert all(np.isfinite(v).all() and len(v) == 2 for v in first.values())
    init = ev.load_init()
    assert init["batches_used"] == 2 and init["disc_epoch"] == 2
    order = ds.permutation(0)
    np.testing.assert_array_equal(
        init["img_real_used"][1], ds.images[order[4:8]].astype(np.float32) / 127.5 - 1.0)

    assert ev.evaluate(continue_=True) == first and ev.epoch_seconds == {}
    results_file = tmp_path / "fids.pickle"
    results = pickle.loads(results_file.read_bytes())
    del results[1]
    results_file.write_bytes(pickle.dumps(results))
    assert ev.evaluate(continue_=True) == first and sorted(ev.epoch_seconds) == [1]


def test_cli_wipes_unless_continue_and_refuses_inception(run_dir, tmp_path, capsys):
    out = tmp_path / "out"
    (out / "evaluation").mkdir(parents=True)
    (out / "evaluation" / "stale.txt").write_text("wiped unless -ct")
    argv = ["2", "-b", str(BATCH), "-d", str(run_dir / "train"), "-o", str(out),
            "-x", str(run_dir / "data"), "-se", "2", "--height", str(H), "--width", str(W),
            "--device", "cpu"]
    tcli.main(argv)
    ev_dir = out / "evaluation"
    assert not (ev_dir / "stale.txt").exists()
    assert sorted(pickle.loads((ev_dir / "fids.pickle").read_bytes())) == [2]
    assert (ev_dir / "fids_boxplot.png").exists() and (ev_dir / "fids_line.png").exists()
    (ev_dir / "kept.txt").write_text("kept with -ct")
    tcli.main([*argv, "-ct"])
    assert (ev_dir / "kept.txt").exists()
    with pytest.raises(SystemExit):
        tcli.main([*argv, "--inception"])
    assert "not ported" in capsys.readouterr().err
    with pytest.raises(NotImplementedError):
        tfid.FIDEvaluator(str(run_dir / "train"), str(tmp_path), feature_source="inception",
                          device=CPU)
