"""Spatial H-partitioning of the port on the CPU: gloo ranks against JAX.

The JAX package trains SNDCGAN and WGAN on a (data, spatial) mesh, its
batch sharded P('data', 'spatial') and the halo exchanges left to XLA
(tests/test_parallel.py: the float64 multi-step mesh tests at 32x32, base
16, batch 4). The port writes the exchanges by hand (parallel/halo.py)
and reduces over named groups (parallel/dp.py). Here:

- 4 spawned ranks (data 2 x spatial 2, gloo, float64, one thread each)
  run 4 steps and are held against the JAX one-device float64 step on the
  global batch, leaf by leaf within the mesh tests' bound max(1e-8, 1e-6 *
  max|leaf|): SNDCGAN with dropout 0.5 (the JAX mesh test runs 0.0; the
  mask at the global element index of a row block is what the port can get
  wrong), WGAN with the clip and with the gradient penalty at n_critic 2.
  The free runs take tests/test_torch_dp.py's rule, one absolute bound
  for wgan_clip's critic nu of conv0_bn's bias (`ABSOLUTE`: its module
  docstring gives the readings, the same on 2 x 2 ranks as on 2). Beside
  them the two WGAN runs are replayed, each step from the JAX state before
  it, every leaf within the relative bound at every step. The 4 ranks'
  states are bit-equal, and each rank counts its collectives;
- the halo alone, on 2 ranks (data 1 x spatial 2): a SAME conv (3x3 s1,
  4x4 s2) and a SAME ConvTranspose (4x4 s2, 3x3 s2) on an H-shard, forward
  and backward, equal the JAX layer on the whole map (float64, 1e-12), and
  a gradient-penalty-style double backward equals the port on the whole
  map;
- the dropout mask of a (rows, image rows) shard is the JAX hash1 mask of
  the whole array at the shard's elements (no spawn);
- the guard (core/mesh.check_spatial_partition) accepts and refuses what
  the JAX guard does, the environment override included, and the models'
  `min_sharded_height` is the JAX one;
- the SNDCGAN and CycleGAN trainers train an epoch with `--mesh-data 1
  --mesh-spatial 2` on the CPU, and the CycleGAN trainer refuses what the
  guard refuses (tests/test_torch_spatial_cyclegan.py holds the CycleGAN
  spatial step against JAX).

Workers are module-level functions of this module or of
tests/test_torch_dp.py, whose helpers this module reuses; both import JAX
only inside the functions the parent runs, and every worker reports
whether `jax` is in its `sys.modules`.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import sys

import numpy as np
import pytest
import torch

from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.core import mesh as meshlib
from imagegeneration_tpu_torch.models import sndcgan as tsnd_model
from imagegeneration_tpu_torch.models import wgan as twgan_model
from imagegeneration_tpu_torch.nn import layers as tl
from imagegeneration_tpu_torch.ops import dropout as tdrop
from imagegeneration_tpu_torch.parallel import dp
from imagegeneration_tpu_torch.tools import dp_parity
from test_torch_dp import (
    REPLAYED,
    STEPS,
    _gp_eps,
    check_free_run,
    check_replay,
    _jax_run,
    _jax_state0,
    _jobs,
    _write_folder,
)

torch.set_num_threads(1)

DATA, SPATIAL = 2, 2
RUNS = ["sndcgan", "wgan_clip", "wgan_gp"]


def _spawn(fn, world, spatial, *args):
    return dp.spawn_local(fn, world, "cpu", args=args, num_threads=1, timeout=600,
                          spatial=spatial)


# ------------------------------------------------- the f64 multi-step runs
def _steps_worker(group, jobs):
    out = {name: dp_parity.run_steps(group, family, cfg, inputs, init)
           for name, family, cfg, inputs, init in jobs}
    return {"runs": out, "coords": (group.d, group.s), "jax_imported": "jax" in sys.modules}


@pytest.fixture(scope="module")
def f64_runs():
    """{name: (4 ranks' results, JAX metrics, JAX final state, JAX states
    after each step)} for the free runs and, named `<run>_replayed`, the
    replayed ones. The WGAN JAX runs come first (the replays start from
    their states); the ranks then run while the parent runs the JAX SNDCGAN
    step."""
    import jax

    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        jobs, want, jax_side = [], {}, {}
        for name, family, cfg, inputs in _jobs():
            if name not in RUNS:
                continue
            js, jcfg, state, as_dict, state0 = _jax_state0(name)
            if name == "wgan_gp":
                inputs["gp_eps"] = _gp_eps(jcfg)
            jobs.append((name, family, cfg, inputs, state0))
            if name in REPLAYED:
                want[name] = _jax_run(name, inputs, js, jcfg, state, as_dict)
                want[f"{name}_replayed"] = want[name]
                jobs.append((f"{name}_replayed", family, cfg, inputs,
                             [state0] + want[name][2][:-1]))
            jax_side[name] = (inputs, js, jcfg, state, as_dict)
        with concurrent.futures.ThreadPoolExecutor(1) as threads:
            ranks = threads.submit(_spawn, _steps_worker, DATA * SPATIAL, SPATIAL, jobs)
            for name in RUNS:
                if name not in want:
                    want[name] = _jax_run(name, *jax_side[name])
            out = ranks.result()
    finally:
        jax.config.update("jax_enable_x64", old)
    assert not any(o["jax_imported"] for o in out)
    assert [o["coords"] for o in out] == [(d, s) for d in range(DATA) for s in range(SPATIAL)]
    return {name: ([o["runs"][name] for o in out], *want[name]) for name in want}


@pytest.mark.parametrize("name", RUNS)
def test_spatial_ranks_match_the_jax_step_on_the_global_batch(f64_runs, name):
    ranks, want_metrics, want_state, _ = f64_runs[name]
    check_free_run(name, ranks[0], want_metrics, want_state)


@pytest.mark.parametrize("name", REPLAYED)
def test_spatial_ranks_match_each_jax_step_replayed_from_its_state(f64_runs, name):
    ranks, _, _, want_states = f64_runs[f"{name}_replayed"]
    check_replay(name, ranks[0], want_states)


# Per step: halo exchanges (forward and adjoint) and spatial sums. SNDCGAN:
# G 4 convs, D 7; the G pass runs G and D forward and back (22), each D
# pass D forward and back but for the input's adjoint (13 + 13); 2 head sums
# per D pass and 1 per G pass, forward only. WGAN (clip) per step: a fake
# batch (G forward, 4), two critic updates (7 + 6 each), and on gan steps
# G and D forward and back (22); GP adds its critic pass and the gradient
# to x_hat (7 + 7), the double backward through both (7 + 6: x_hat is a
# leaf) and 1 norm sum.
HALOS = {"sndcgan": 48 * STEPS, "wgan_clip": 4 * 4 + 13 * 8 + 22 * 2,
         "wgan_gp": 4 * 4 + 13 * 8 + 22 * 2 + 27 * 4}
SPATIAL_SUMS = {"sndcgan": 3 * STEPS, "wgan_clip": 2 * STEPS + 2, "wgan_gp": 4 * STEPS + 2}


@pytest.mark.parametrize("name", RUNS + [f"{n}_replayed" for n in REPLAYED])
def test_spatial_ranks_are_bit_equal_and_count_their_collectives(f64_runs, name):
    """Every rank's digest is rank 0's; per rank: one gradient all-reduce per
    optimizer apply, one metric all-reduce, the halo exchanges and spatial
    sums the step's structure gives."""
    ranks = f64_runs[name][0]
    name = name.removesuffix("_replayed")
    assert len({r["digest"] for r in ranks}) == 1
    applies = {"sndcgan": 3 * STEPS, "wgan_clip": 2 * STEPS + STEPS // 2,
               "wgan_gp": 2 * STEPS + STEPS // 2}
    for r in ranks:
        c = r["collectives"]
        assert c["grad_all_reduce"] == applies[name]
        assert c["metric_all_reduce"] == 1
        assert c["halo"] == HALOS[name], c
        assert c["spatial_sum"] == SPATIAL_SUMS[name], c


# ------------------------------------------------------------ the halo
CASES = {  # name: (kind, kernel, stride)
    "conv3x3s1": ("conv", 3, 1), "conv4x4s2": ("conv", 4, 2),
    "convT4x4s2": ("convT", 4, 2), "convT3x3s2": ("convT", 3, 2),
}
H, W, CIN, COUT = 8, 6, 3, 4


def _layer(kind, k, s, kernel, cin=CIN, cout=COUT):
    """A float64 port layer holding the flax `kernel`."""
    if kind == "conv":
        m = tl.Conv(cin, cout, (k, k), (s, s), "SAME", use_bias=False, dtype=torch.float64)
    else:
        m = tl.ConvTranspose(cin, cout, (k, k), (s, s), use_bias=False, dtype=torch.float64)
    m.double()
    bridge.copy_in(m.weight, kind, kernel)
    return m


def _chain(kernels):
    """conv 4x4 s2 -> leaky -> ConvTranspose 4x4 s2: H -> H/2 -> H."""
    return torch.nn.Sequential(_layer("conv", 4, 2, kernels[0]), torch.nn.LeakyReLU(0.2),
                               _layer("convT", 4, 2, kernels[1], COUT, CIN))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _penalty(model, x, r, group):
    """sum over the image of |d sum(model(x) * r) / dx|^2 and its parameter
    gradients (a double backward through the halo exchanges)."""
    x = x.detach().requires_grad_(True)
    (g,) = torch.autograd.grad((model(x) * r).sum(), x, create_graph=True)
    sq = (g * g).sum()
    if group is not None:
        sq = dp.spatial_sum(sq.reshape(1), group)[0]
    grads = torch.autograd.grad(sq, list(model.parameters()))
    return float(sq.detach()), [gr.numpy() for gr in grads]


def _halo_worker(group, x, dy, kernels, chain_kernels, r):
    lo, hi = meshlib.spatial_row_range(group, x.shape[1])
    out = {}
    for name, (kind, k, s) in CASES.items():
        m = _layer(kind, k, s, kernels[name])
        tl.partition(m, group)
        xs = _nchw(x[:, lo:hi]).requires_grad_(True)
        y = m(xs)
        rows = slice(*meshlib.spatial_row_range(group, dy[name].shape[1]))
        y.backward(_nchw(dy[name][:, rows]))
        out[name] = {"y": y.detach().permute(0, 2, 3, 1).numpy(),
                     "dx": xs.grad.permute(0, 2, 3, 1).numpy(),
                     "dw": bridge.to_flax_layout(kind, m.weight.grad.numpy())}
    chain = _chain(chain_kernels)
    tl.partition(chain, group)
    out["penalty"] = _penalty(chain, _nchw(x[:, lo:hi]), _nchw(r[:, lo:hi]), group)
    return {"out": out, "halo": group.counts["halo"], "jax_imported": "jax" in sys.modules}


@pytest.fixture(scope="module")
def halo_runs():
    """2 ranks' shards and the JAX layers on the whole map (float64)."""
    import jax
    import jax.numpy as jnp

    from imagegeneration_tpu.nn import layers as jl

    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, H, W, CIN))
    r = rng.normal(size=(2, H, W, CIN))
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    want, kernels, dy = {}, {}, {}
    try:
        for name, (kind, k, s) in CASES.items():
            cls = jl.Conv if kind == "conv" else jl.ConvTranspose
            mod = cls(COUT, (k, k), (s, s), "SAME", use_bias=False, param_dtype=jnp.float64,
                      dtype=jnp.float64)
            v = mod.init(jax.random.key(len(name)), jnp.asarray(x))
            y, vjp = jax.vjp(lambda p, xx: mod.apply(p, xx), v, jnp.asarray(x))
            dy[name] = rng.normal(size=y.shape)
            dv, dx = vjp(jnp.asarray(dy[name]))
            (kernels[name],) = [np.asarray(a) for a in jax.tree.leaves(v)]
            want[name] = {"y": np.asarray(y), "dx": np.asarray(dx),
                          "dw": np.asarray(jax.tree.leaves(dv)[0])}
    finally:
        jax.config.update("jax_enable_x64", old)
    chain_kernels = [rng.normal(size=(4, 4, CIN, COUT)) * 0.3,
                     rng.normal(size=(4, 4, COUT, CIN)) * 0.3]
    ranks = _spawn(_halo_worker, SPATIAL, SPATIAL, x, dy, kernels, chain_kernels, r)
    whole = _penalty(_chain(chain_kernels), _nchw(x), _nchw(r), None)
    return ranks, want, whole


@pytest.mark.parametrize("name", list(CASES))
def test_halo_layers_equal_the_jax_layer_on_the_whole_map(halo_runs, name):
    ranks, want, _ = halo_runs
    assert not any(r["jax_imported"] for r in ranks)
    got = [r["out"][name] for r in ranks]
    tol = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got], 1), want[name]["y"], **tol)
    np.testing.assert_allclose(np.concatenate([g["dx"] for g in got], 1), want[name]["dx"],
                               **tol)
    # each rank's weight gradient is its shard's part; the parts sum to the whole
    np.testing.assert_allclose(sum(g["dw"] for g in got), want[name]["dw"], **tol)
    # one forward and one adjoint exchange per layer; the penalty's chain:
    # 2 forward, 2 adjoint (to x), then its double backward 2 forward
    # through the adjoints and 1 adjoint (x is a leaf)
    assert all(r["halo"] == 2 * len(CASES) + 7 for r in ranks)


def test_halo_double_backward_equals_the_whole_map(halo_runs):
    ranks, _, (pen, grads) = halo_runs
    for r in ranks:
        got_pen, got_grads = r["out"]["penalty"]
        assert got_pen == pytest.approx(pen, rel=1e-12)
    for i, want in enumerate(grads):
        np.testing.assert_allclose(sum(r["out"]["penalty"][1][i] for r in ranks), want,
                                   rtol=1e-11, atol=1e-12)


# ------------------------------------------------------------- the mask
@pytest.mark.parametrize("shape,data,spatial", [((4, 8, 6, 5), 2, 2), ((2, 12, 4, 3), 1, 3),
                                                 ((4, 16, 16, 64), 2, 4)])
def test_plain_mask_of_a_row_block_is_the_jax_global_mask(shape, data, spatial):
    """The plain mask of each (rows, image rows) shard is bit-equal to the JAX
    hash1 mask of the whole (B, H, W, C) array at those elements, and the
    fused forward/backward of the shard equals the whole array's there."""
    import jax.numpy as jnp

    from imagegeneration_tpu.ops import bitdropout

    cut = tdrop.dropout_cut(0.5)
    kw = np.random.default_rng(sum(shape)).integers(0, 2**32, 2, dtype=np.uint64)
    want = np.asarray(bitdropout._hash_mask(
        jnp.asarray(kw.astype(np.uint32)), jnp.ones(shape, jnp.float32), cut,
        (256 - cut) / 256.0, rounds=1)) != 0
    kwt = torch.from_numpy(kw.astype(np.int64))
    rng = np.random.default_rng(4)
    x = _nchw(rng.normal(size=shape))
    g = _nchw(rng.normal(size=shape))
    full_y, full_dx = tdrop.fwd_plain(x, kwt, cut), tdrop.bwd_plain(x, g, kwt, cut)
    b, h = shape[0] // data, shape[1] // spatial
    for d in range(data):
        for s in range(spatial):
            rows, hrows = slice(d * b, (d + 1) * b), slice(s * h, (s + 1) * h)
            xs = x[rows, :, hrows].contiguous(memory_format=torch.channels_last)
            base = tdrop.rows_base(xs, d * b, shape[1])
            got = tdrop.hash_keep_mask(kwt, xs.numel(), cut, base,
                                       tdrop.row_map(xs, (s * h, shape[1])))
            np.testing.assert_array_equal(got.view(b, h, *shape[2:]).numpy(),
                                          want[rows, hrows])
            xs.requires_grad_(True)
            y = tdrop.leaky_relu_dropout(xs, kwt, 0.5, rows=(d * b, shape[0]),
                                         hblock=(s * h, shape[1]))
            y.backward(g[rows, :, hrows])
            assert torch.equal(y.detach(), full_y[rows, :, hrows])
            assert torch.equal(xs.grad, full_dx[rows, :, hrows])


def test_row_block_index_range_is_checked():
    x = torch.zeros((2, 3, 4, 5)).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="outside the 6 rows"):
        tdrop.row_map(x, (3, 6))
    # rows 2 and 3 of a 2-row batch (the last row runs past the total)
    with pytest.raises(ValueError, match="outside"):
        tdrop.fwd(x, torch.zeros(2, dtype=torch.int64), 128, tdrop.rows_base(x, 1, 8),
                  tdrop.rows_base(x, 2, 8), hblock=(0, 8))
    assert tdrop.index_extent(x, (2, 8)) == (2 - 1) * 8 * 15 + 6 * 15


# ------------------------------------------------------------- the guard
@pytest.mark.parametrize("min_h,spatial", [(4, 2), (2, 2), (9, 2), (36, 2), (36, 4), (36, 8),
                                           (5, 1), (4, 3)])
def test_guard_accepts_and_refuses_as_the_jax_guard(min_h, spatial, monkeypatch):
    from imagegeneration_tpu.core import mesh as jmesh

    def verdict(fn):
        try:
            fn(min_h, spatial, "sndcgan", 8 * min_h)
        except ValueError as e:
            assert "WRONG below 2" in str(e)
            return "refused"
        return "accepted"

    assert verdict(meshlib.check_spatial_partition) == verdict(jmesh.check_spatial_partition)
    monkeypatch.setenv("IMAGEGEN_ALLOW_DEGENERATE_SPATIAL", "1")
    if verdict(jmesh.check_spatial_partition) == "accepted" and min_h // spatial < 2:
        with pytest.warns(RuntimeWarning, match="WRONG below 2"):
            meshlib.check_spatial_partition(min_h, spatial, "wgan", 8 * min_h)


def test_min_sharded_height_is_the_jax_one():
    from imagegeneration_tpu.models import sndcgan as jsnd
    from imagegeneration_tpu.models import wgan as jwgan

    for hw in ((288, 512), (32, 32), (144, 256)):
        assert tsnd_model.min_sharded_height(tsnd_model.SNDCGANConfig(image_size=(*hw, 3))) \
            == jsnd.min_sharded_height(jsnd.SNDCGANConfig(image_size=(*hw, 3)))
        assert twgan_model.min_sharded_height(twgan_model.WGANConfig(image_size=(*hw, 3))) \
            == jwgan.min_sharded_height(jwgan.WGANConfig(image_size=(*hw, 3)))


def test_engines_refuse_a_degenerate_partition(tmp_path):
    """16x16 on 2 spatial ranks leaves 1 row per shard at H/8: both engines
    refuse it at construction, before they touch their directory."""
    from imagegeneration_tpu_torch.core.data import SyntheticImageDataset
    from imagegeneration_tpu_torch.train.sndcgan_engine import SNDCGANEngine
    from imagegeneration_tpu_torch.train.wgan_engine import WGANEngine

    group = meshlib.DataGroup(pg=None, rank=0, world=4, device=torch.device("cpu"),
                              backend="gloo", spatial=2)
    ds = SyntheticImageDataset(8, (16, 16), seed=3)
    with pytest.raises(ValueError, match="WRONG below 2"):
        WGANEngine(ds, (16, 16, 3), 8, path_like=str(tmp_path / "w"),
                   device=torch.device("cpu"), mesh=group)
    with pytest.raises(ValueError, match="WRONG below 2"):
        SNDCGANEngine(str(tmp_path / "s"), ds, 8, image_size=(16, 16, 3), base_width=16,
                      device=torch.device("cpu"), mesh=group)
    with pytest.raises(ValueError, match="spatial=False"):
        SNDCGANEngine(str(tmp_path / "s"), ds, 8, image_size=(32, 32, 3), base_width=16,
                      device=torch.device("cpu"), mesh=group, spatial=False)
    assert not os.path.exists(tmp_path / "w") and not os.path.exists(tmp_path / "s")


def test_mesh_coordinates_and_row_ranges():
    group = meshlib.DataGroup(pg=None, rank=3, world=6, device=torch.device("cpu"),
                              backend="gloo", spatial=3)
    assert (group.data, group.d, group.s) == (2, 1, 0)
    assert meshlib.process_row_range(group, 8) == (4, 8)
    assert meshlib.spatial_row_range(group, 36) == (0, 12)
    with pytest.raises(ValueError, match="not divisible by the spatial axis"):
        meshlib.spatial_row_range(group, 10)
    with pytest.raises(ValueError, match="no 'spatial' group"):
        meshlib.DataGroup(pg=None, rank=0, world=2, device=torch.device("cpu"),
                          backend="gloo").pg_of("spatial")


# ------------------------------------------------------------- the CLIs
def test_sndcgan_trainer_trains_on_two_spatial_ranks(tmp_path):
    from imagegeneration_tpu_torch.cli import sndcgan_trainer

    _write_folder(str(tmp_path / "data" / "class0"), 8, 7, size=(40, 40))
    out = tmp_path / "run"
    sndcgan_trainer.main(["4", "0", "-x", str(tmp_path / "data"), "-d", str(out),
                          "--height", "32", "--width", "32", "--device", "cpu",
                          "--mesh-data", "1", "--mesh-spatial", "2",
                          "-lo", str(tmp_path / "live")])
    with open(out / "perf.jsonl") as f:
        perf = [json.loads(line) for line in f]
    assert len(perf) == 1 and perf[0]["ranks"] == 2 and perf[0]["images_per_sec"] > 0
    assert (out / "models" / "generator" / "gen_model-0.msgpack").exists()


@pytest.mark.parametrize("argv,message", [
    (["--height", "16", "--width", "16"], "WRONG below 2"),
    (["--height", "32", "--width", "32", "--mesh-data", "0"], "needs --mesh-data >= 1"),
])
def test_wgan_trainer_refuses_what_the_guard_refuses(argv, message, tmp_path, capsys):
    from imagegeneration_tpu_torch.cli import wgan_trainer

    base = ["4", "1", "-d", str(tmp_path / "run"), "--device", "cpu", "--mesh-spatial", "2"]
    with pytest.raises(SystemExit):
        wgan_trainer.main(base + (argv if "--mesh-data" in argv else argv + ["--mesh-data", "1"]))
    assert message in capsys.readouterr().err


def test_cyclegan_trainer_refuses_spatial(tmp_path, capsys):
    """The CycleGAN trainer refuses what the guard refuses (16 rows: 1 row
    per shard of 4 at H/4) and trains an epoch on 2 spatial ranks at 96x96
    (the CLI's default model: base 64, 9 res blocks; ~7 s here)."""
    from imagegeneration_tpu_torch.cli import cyclegan_trainer

    with pytest.raises(SystemExit):
        cyclegan_trainer.main(["4", "1", "-d", str(tmp_path / "refused"), "--device", "cpu",
                               "--mesh-data", "1", "--mesh-spatial", "4", "--height", "16",
                               "--width", "16"])
    assert "WRONG below 2" in capsys.readouterr().err
    for domain, seed in (("x", 1), ("y", 2)):
        _write_folder(str(tmp_path / domain), 2, seed, size=(100, 100))
    out = tmp_path / "run"
    cyclegan_trainer.main(["2", "1", "-x", str(tmp_path / "x"), "-y", str(tmp_path / "y"),
                           "-d", str(out), "-c", "1", "--height", "96", "--width", "96",
                           "--device", "cpu", "--mesh-data", "1", "--mesh-spatial", "2"])
    with open(out / "perf.jsonl") as f:
        perf = [json.loads(line) for line in f]
    assert len(perf) == 1 and perf[0]["ranks"] == 2 and perf[0]["images_per_sec"] > 0
    assert (out / "models" / "generator_g" / "gen_weights_g-0.msgpack").exists()
    assert (out / "checkpoints").is_dir() and not (tmp_path / "refused").exists()


def test_dryrun_multichip_data_by_spatial():
    from imagegeneration_tpu_torch.tools import dryrun_multichip

    out = dryrun_multichip.dryrun_multichip(4, 2)
    assert out["step"] == 1 and out["grad_all_reduces"] == 3 and out["halo_exchanges"] == 48
    assert not out["jax_imported"] and np.isfinite(out["metrics"]["g_loss"])
