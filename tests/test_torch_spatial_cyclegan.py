"""Spatial H-partitioning of the port's CycleGAN step on the CPU: gloo ranks
against JAX.

The JAX package trains CycleGAN on a (data, spatial) mesh, its batches
sharded P('data', 'spatial') and the cross-shard InstanceNorm reductions,
reflect pads and the PatchGAN's re-replication left to XLA
(tests/test_parallel.py: the float64 4-step mesh test at 96x96, base 8, 1
res block, batch 4, seed 7, `in_backend="xla"`). The port writes them by
hand: the split InstanceNorm (ops/instance_norm.py: partial sums, one
all_gather, apply; backward likewise around one all_reduce), the reflect
halo (nn/layers.reflect_halo), the PatchGAN's row gather
(parallel/halo.gather_rows) with its gradients counted once
(train/cyclegan_step.count_once). Here:

- 4 spawned ranks (data 2 x spatial 2, gloo, float64, one thread each) run
  that configuration for 4 steps, and 2 steps with `quirk_axis1=True`, and
  are held against the JAX one-device float64 step on the global batches,
  leaf by leaf within the mesh tests' bound max(1e-8, 1e-6 * max|leaf|),
  with tests/test_torch_dp.py's absolute bound on the two discriminator
  head kernels (`ABSOLUTE["cyclegan"]`) and no other exemption; the 4
  ranks' states are bit-equal, and each rank counts the collectives the
  step's structure gives;
- the split plain norms on S in {2, 3, 4} row blocks simulated in one
  process (the partials concatenated in place of the gather, the sums
  added in place of the all_reduce) equal JAX `_in_fwd_xla` /
  `_in_bwd_xla` on the whole map: 1e-12 in float64, 1e-5 of the largest
  value in float32, ReLU on and off;
- the reflect halo with a VALID 3x3 s2 conv on 4 ranks (data 1 x spatial
  4, so that two ranks have neighbours on both sides) equals JAX's
  `reflection_pad_2d` and VALID conv on the whole map, forward and
  backward (1e-12);
- the guard: the CycleGAN `min_sharded_height` is the JAX engine's H // 4,
  the engine refuses a degenerate partition before touching its
  directory, and the CycleGAN trainer trains an epoch on 2 spatial ranks
  (in tests/test_torch_spatial.py, with the other families' CLIs).

Workers are module-level functions of this module; it imports JAX only
inside the functions the parent runs, and every worker reports whether
`jax` is in its `sys.modules`. It reuses tests/test_torch_dp.py's helpers.
"""

from __future__ import annotations

import concurrent.futures
import os
import sys

import numpy as np
import pytest
import torch

from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.core import mesh as meshlib
from imagegeneration_tpu_torch.models import cyclegan as tcyc_model
from imagegeneration_tpu_torch.nn import layers as tl
from imagegeneration_tpu_torch.ops import instance_norm as tin
from imagegeneration_tpu_torch.parallel import dp
from imagegeneration_tpu_torch.tools import dp_parity
from imagegeneration_tpu_torch.train import cyclegan_step as tcyc
from test_torch_dp import (ABSOLUTE, B, STEPS, _leaf_bound, _tree_leaves, _worst,
                           check_free_run, to_parent)

torch.set_num_threads(1)

DATA, SPATIAL = 2, 2
IMAGE = (96, 96, 3)
QUIRK_STEPS = 2
RUNS = {"cyclegan": (False, STEPS), "cyclegan_quirk": (True, QUIRK_STEPS)}


def _spawn(fn, world, spatial, *args):
    return dp.spawn_local(fn, world, "cpu", args=args, num_threads=1, timeout=600,
                          spatial=spatial)


def _inputs(steps):
    rng = np.random.default_rng(12)
    return {"batches_x": rng.integers(0, 256, (steps, B, *IMAGE), np.uint8),
            "batches_y": rng.integers(0, 256, (steps, B, *IMAGE), np.uint8)}


def _port_config(quirk):
    return tcyc.CycleGANTrainConfig(
        model=tcyc_model.CycleGANConfig(image_size=IMAGE, base_width=8, n_res_blocks=1,
                                        quirk_axis1=quirk, dtype=torch.float64),
        batch_size=B, seed=7)


def _jax_init(quirk):
    """(step module, config, state, state as the bridge's numpy tree) of the
    JAX one-device float64 CycleGAN (x64 on)."""
    import jax
    import jax.numpy as jnp

    from imagegeneration_tpu.models.cyclegan import CycleGANConfig
    from imagegeneration_tpu.train import cyclegan_step as js

    cfg = js.CycleGANTrainConfig(model=CycleGANConfig(
        image_size=IMAGE, base_width=8, n_res_blocks=1, quirk_axis1=quirk, in_backend="xla",
        dtype=jnp.float64), batch_size=B, seed=7)
    state = js.init_state(cfg)
    return js, cfg, state, _as_dict(jax.device_get(state))


def _as_dict(s):
    out = {"step": s.step}
    for key in ("gg", "gf", "dx", "dy"):
        o = getattr(s, f"{key}_opt")
        out[f"{key}_params"] = getattr(s, f"{key}_params")
        out[f"{key}_opt"] = {"count": o.count, "mu": o.mu, "nu": o.nu}
    return out


def _jax_steps(js, cfg, state, inputs):
    """(metrics per step, final state) of the JAX step on the global batches."""
    import jax

    step = jax.jit(js.make_train_step(cfg))
    metrics = []
    for bx, by in zip(inputs["batches_x"], inputs["batches_y"]):
        state, m = step(state, bx, by)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _as_dict(jax.device_get(state))


def _steps_worker(group, jobs):
    out = {name: to_parent(dp_parity.run_steps(group, "cyclegan", cfg, inputs, init),
                           group.rank, False)
           for name, cfg, inputs, init in jobs}
    return {"runs": out, "coords": (group.d, group.s), "jax_imported": "jax" in sys.modules}


@pytest.fixture(scope="module")
def f64_runs():
    """{name: (4 ranks' results, the port's one-process result, JAX
    metrics, JAX final state)}: the JAX initial states first, then the
    ranks run while the parent runs the JAX steps and the port's
    one-process steps from the same state."""
    import jax

    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        jobs, jax_side = [], {}
        for name, (quirk, steps) in RUNS.items():
            js, cfg, state, state0 = _jax_init(quirk)
            inputs = _inputs(steps)
            jobs.append((name, _port_config(quirk), inputs, state0))
            jax_side[name] = (js, cfg, state, inputs)
        with concurrent.futures.ThreadPoolExecutor(1) as threads:
            ranks = threads.submit(_spawn, _steps_worker, DATA * SPATIAL, SPATIAL, jobs)
            want = {name: _jax_steps(*side) for name, side in jax_side.items()}
            one = {name: dp_parity.run_steps(None, "cyclegan", cfg, inputs, init)
                   for name, cfg, inputs, init in jobs}
            out = ranks.result()
    finally:
        jax.config.update("jax_enable_x64", old)
    assert not any(o["jax_imported"] for o in out)
    assert [o["coords"] for o in out] == [(d, s) for d in range(DATA) for s in range(SPATIAL)]
    return {name: ([o["runs"][name] for o in out], one[name], *want[name]) for name in RUNS}


def test_spatial_ranks_match_the_jax_step_on_the_global_batch(f64_runs):
    """Every metric within rtol 1e-5, the final state leaf by leaf within the
    mesh bound (the heads' absolute bound of `ABSOLUTE["cyclegan"]`)."""
    ranks, _, want_metrics, want_state = f64_runs["cyclegan"]
    assert len(ranks[0]["metrics"]) == STEPS
    check_free_run("cyclegan", ranks[0], want_metrics, want_state)


def test_spatial_ranks_match_the_jax_quirk_step_where_one_process_does(f64_runs):
    """quirk_axis1: every metric within rtol 1e-5 of JAX's; every leaf within
    the mesh bound of JAX's, but the heads (ABSOLUTE) and the leaves that the
    port's one-process run itself misses against JAX (`_port_gap`): there
    the quirk norm's per-row statistics leave D's gradients near 0, where
    Adam magnifies the float32 rounding of the BCE cotangents (the class of
    ABSOLUTE), with the ranks or without. Those leaves are D's only, and
    the ranks hold them to the one-process run (the next test)."""
    ranks, one, want_metrics, want_state = f64_runs["cyclegan_quirk"]
    assert len(ranks[0]["metrics"]) == QUIRK_STEPS
    gap = _port_gap(one["state"], want_state)
    assert all(leaf.split("/")[1][:2] in ("dx", "dy") for leaf in gap), gap
    for i, (m, w) in enumerate(zip(ranks[0]["metrics"], want_metrics)):
        for k in w:
            assert m[k] == pytest.approx(w[k], rel=1e-5, abs=1e-7), f"step {i + 1} {k}"
    g, w = dict(_tree_leaves(ranks[0]["state"])), dict(_tree_leaves(want_state))
    for leaf, bound in ABSOLUTE["cyclegan"].items():
        assert np.abs(g[leaf] - w[leaf]).max() <= bound, leaf
    ratio, leaf = _worst(ranks[0]["state"], want_state,
                         skip=(*ABSOLUTE["cyclegan"], *gap))
    assert ratio <= 1.0, f"leaf {leaf} at {ratio:.3g} of its bound"


def _port_gap(port_state, want_state) -> list[str]:
    """The leaves of a port state beyond the mesh bound of JAX's."""
    g, w = dict(_tree_leaves(port_state)), dict(_tree_leaves(want_state))
    return [k for k in w if np.abs(g[k] - w[k]).max() > _leaf_bound(w[k])]


@pytest.mark.parametrize("name", list(RUNS))
def test_spatial_ranks_equal_the_port_on_one_process(f64_runs, name):
    """The 2 x 2 ranks against the port's one-process run of the same steps
    from the same state: every metric within rtol 1e-6, every leaf within
    the mesh bound, the heads included."""
    ranks, one, *_ = f64_runs[name]
    for m, w in zip(ranks[0]["metrics"], one["metrics"]):
        for k in w:
            assert m[k] == pytest.approx(w[k], rel=1e-6, abs=1e-9), k
    ratio, leaf = _worst(ranks[0]["state"], one["state"])
    assert ratio <= 1.0, f"leaf {leaf} at {ratio:.3g} of its bound"


def _collectives_per_step(n_res):
    """Per rank and step: one generator pass has a halo exchange for the 7x7
    stem and to_rgb convs, the two reflect pads, the 2 * n_res res-block
    convs and the two ConvTransposes (P = 6 + 2 * n_res), and 6 + 2 * n_res
    norms. The forward runs 6 generator passes and 4 PatchGAN passes (one
    row gather each) and 4 L1 sums; pulls 1 and 2 each run 4 generator
    passes back, and in 3 of them the pull needs no gradient of the input
    (a batch; in pull 1 F(y), which only F's parameters reach; in pull 2
    G(x)), so their stem exchanges no adjoint; a gather's backward
    exchanges nothing."""
    p = 6 + 2 * n_res
    return {"halo": 14 * p - 6, "norm_gather": 6 * p, "norm_all_reduce": 8 * p,
            "row_gather": 4, "spatial_sum": 4, "grad_all_reduce": 4}


@pytest.mark.parametrize("name", list(RUNS))
def test_spatial_ranks_are_bit_equal_and_count_their_collectives(f64_runs, name):
    ranks = f64_runs[name][0]
    assert len({r["digest"] for r in ranks}) == 1
    quirk, steps = RUNS[name]
    per_step = _collectives_per_step(1)
    if quirk:  # the quirk norm normalizes each row alone: no collective
        per_step.update(norm_gather=0, norm_all_reduce=0)
    for r in ranks:
        c = r["collectives"]
        assert {k: c[k] for k in per_step} == {k: v * steps for k, v in per_step.items()}, c
        assert c["metric_all_reduce"] == 1 and c["stat_all_reduce"] == 0
        # the CPU takes the plain versions: no kernel launch is counted
        assert set(r["launches"].values()) == {0}


# ------------------------------------------------------- the split norms
def _split_plain(x, dy, gamma, beta, eps, relu, shards, mean_rstd, splits=1):
    """The split plain norm over `shards` row blocks of the whole (B, C, H, W)
    x in one process, each block's forward partial cut into `splits` chunks
    of rows: (y, mean, rstd, dx, dgamma, dbeta), dx from the given (mean,
    rstd)."""
    xs, dys = x.chunk(shards, 2), dy.chunk(shards, 2)
    parts = torch.stack([tin.in_fwd_partial_plain(xb, splits) for xb in xs])
    out = [tin.in_fwd_apply_plain(xb, parts, gamma, beta, eps, relu) for xb in xs]
    mean, rstd = mean_rstd
    bwd = [tin.in_bwd_partial_plain(xb, db, gamma, beta, mean, rstd, relu)
           for xb, db in zip(xs, dys)]
    sums = sum(b[0] for b in bwd)
    total = x.shape[2] * x.shape[3]
    dx = [tin.in_bwd_apply_plain(xb, db, sums, gamma, beta, mean, rstd, relu, total)
          for xb, db in zip(xs, dys)]
    return (torch.cat([o[0] for o in out], 2), out[0][1], out[0][2], torch.cat(dx, 2),
            sum(b[1] for b in bwd), sum(b[2] for b in bwd))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shards", [2, 3, 4])
def test_split_plain_norm_equals_the_jax_norm_on_the_whole_map(shards, dtype, relu):
    _check_split_plain_against_jax(shards, 1, dtype, relu)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shards,splits", [(1, 4), (2, 7), (3, 3)])
def test_chunked_split_plain_norm_equals_the_jax_norm_on_the_whole_map(shards, splits,
                                                                       dtype):
    """The forward partial in chunks of each shard's rows, as the kernel
    writes them (30 rows a shard cut at most 7 ways are 6 chunks of 5; 20
    cut 3 ways 7, 7 and 6), merged by the apply's Chan formula over the S x
    k chunks: the same bounds against the JAX norm."""
    _check_split_plain_against_jax(shards, splits, dtype, True)


def _check_split_plain_against_jax(shards, splits, dtype, relu):
    """The split plain pair on `shards` row blocks (forward partials in
    `splits` chunks) against the JAX norm on the whole map: float64 within
    1e-12, float32 within rtol 1e-5 and atol 1e-5 of the output's largest
    |v| (float32 sums in another order)."""
    import jax
    import jax.numpy as jnp

    from imagegeneration_tpu.ops.pallas import instance_norm as jin

    rng = np.random.default_rng(shards + 10 * relu)
    shape = (2, 12, 5, 6)  # (B, H, W, C): H splits into 2, 3 and 4 blocks
    x = 2.0 + 3.0 * rng.normal(size=shape)
    dy = rng.normal(size=shape)
    gamma, beta = 1.0 + 0.1 * rng.normal(size=6), 0.1 * rng.normal(size=6)
    np_dt = np.dtype(dtype)
    x, dy, gamma, beta = (a.astype(np_dt) for a in (x, dy, gamma, beta))
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        jx, jdy, jg, jb = (jnp.asarray(a) for a in (x, dy, gamma, beta))
        y, mean, rstd = jin._in_fwd_xla(jx, jg, jb, 1e-3, relu)
        dx, dgamma, dbeta = jin._in_bwd_xla(jx, jdy, jg, jb, mean, rstd, relu)
        want = [np.asarray(a) for a in (y, mean, rstd, dx, dgamma, dbeta)]
    finally:
        jax.config.update("jax_enable_x64", old)

    def t(a):
        return torch.from_numpy(np.array(a))

    nchw = lambda a: t(a).permute(0, 3, 1, 2)  # noqa: E731
    got = _split_plain(nchw(x), nchw(dy), t(gamma), t(beta), 1e-3, relu, shards,
                       (t(want[1]), t(want[2])), splits)
    got = [g.numpy() for g in got]
    got[0], got[3] = got[0].transpose(0, 2, 3, 1), got[3].transpose(0, 2, 3, 1)
    for name, g, w in zip(("y", "mean", "rstd", "dx", "dgamma", "dbeta"), got, want):
        assert g.dtype == w.dtype, name
        if dtype == "float64":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                       err_msg=name)


def test_split_plain_norm_on_one_shard_is_the_whole_plain_norm():
    """S = 1: the split pair reduces to the single-pass plain versions."""
    gen = torch.Generator().manual_seed(3)
    x = 2.0 + 3.0 * torch.randn((2, 4, 6, 5), generator=gen)
    dy = torch.randn(x.shape, generator=gen)
    gamma, beta = 1.0 + 0.1 * torch.randn(4, generator=gen), 0.1 * torch.randn(4, generator=gen)
    for relu in (False, True):
        y, mean, rstd = tin.in_fwd_plain(x, gamma, beta, 1e-3, relu)
        dx, dgamma, dbeta = tin.in_bwd_plain(x, dy, gamma, beta, mean, rstd, relu)
        got = _split_plain(x, dy, gamma, beta, 1e-3, relu, 1, (mean, rstd))
        for g, w in zip(got, (y, mean, rstd, dx, dgamma, dbeta)):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------ the reflect halo
H, W, CIN, COUT, RANKS = 16, 6, 3, 4, 4


def _halo_worker(group, x, dy, kernel):
    lo, hi = meshlib.spatial_row_range(group, x.shape[1])
    conv = tl.Conv(CIN, COUT, (3, 3), (2, 2), "VALID", use_bias=False, dtype=torch.float64,
                   halo_fed=True).double()
    bridge.copy_in(conv.weight, "conv", kernel)
    tl.partition(conv, group)
    xs = torch.from_numpy(np.ascontiguousarray(x[:, lo:hi])).permute(0, 3, 1, 2)
    xs = xs.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    y = conv(tl.reflection_pad_2d(xs, (1, 1), group))
    rows = slice(*meshlib.spatial_row_range(group, dy.shape[1]))
    y.backward(torch.from_numpy(np.ascontiguousarray(dy[:, rows])).permute(0, 3, 1, 2))
    return {"y": y.detach().permute(0, 2, 3, 1).numpy(),
            "dx": xs.grad.permute(0, 2, 3, 1).numpy(),
            "dw": bridge.to_flax_layout("conv", conv.weight.grad.numpy()),
            "halo": group.counts["halo"], "jax_imported": "jax" in sys.modules}


def test_reflect_halo_and_valid_conv_equal_the_jax_layers_on_the_whole_map():
    """4 ranks of 4 rows: the top and bottom ranks reflect at the global
    edges, the two inner ones take both halo rows from their neighbours."""
    import jax
    import jax.numpy as jnp

    from imagegeneration_tpu.nn import layers as jl

    rng = np.random.default_rng(31)
    x = rng.normal(size=(2, H, W, CIN))
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        mod = jl.Conv(COUT, (3, 3), (2, 2), "VALID", use_bias=False, param_dtype=jnp.float64,
                      dtype=jnp.float64)
        v = mod.init(jax.random.key(4), jnp.asarray(x))
        y, vjp = jax.vjp(lambda p, xx: mod.apply(p, jl.reflection_pad_2d(xx, (1, 1))), v,
                         jnp.asarray(x))
        dy = rng.normal(size=y.shape)
        dv, dx = vjp(jnp.asarray(dy))
        (kernel,) = [np.asarray(a) for a in jax.tree.leaves(v)]
        want = {"y": np.asarray(y), "dx": np.asarray(dx),
                "dw": np.asarray(jax.tree.leaves(dv)[0])}
    finally:
        jax.config.update("jax_enable_x64", old)
    ranks = _spawn(_halo_worker, RANKS, RANKS, x, dy, kernel)
    assert not any(r["jax_imported"] for r in ranks)
    tol = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks], 1), want["y"], **tol)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in ranks], 1), want["dx"], **tol)
    np.testing.assert_allclose(sum(r["dw"] for r in ranks), want["dw"], **tol)
    assert all(r["halo"] == 2 for r in ranks)  # one exchange forward, one adjoint


# ------------------------------------------------------------- the guard
@pytest.mark.parametrize("height", [96, 128, 256])
def test_min_sharded_height_is_the_jax_engines(height):
    """The JAX engine guards at h // 4 (train/cyclegan_engine.py:99-103),
    the JAX model's min_sharded_height."""
    from imagegeneration_tpu.models import cyclegan as jcyc

    cfg = tcyc_model.CycleGANConfig(image_size=(height, height, 3))
    assert tcyc_model.min_sharded_height(cfg) == height // 4 == jcyc.min_sharded_height(
        jcyc.CycleGANConfig(image_size=(height, height, 3)))


def test_engine_refuses_a_degenerate_partition(tmp_path):
    """16x16 on 4 spatial ranks leaves 1 row per shard at H/4: refused at
    construction, before the engine touches its directory; spatial=False
    refuses a partitioning group."""
    from imagegeneration_tpu_torch.core.data import SyntheticImageDataset
    from imagegeneration_tpu_torch.train.cyclegan_engine import CycleGANEngine

    group = meshlib.DataGroup(pg=None, rank=0, world=4, device=torch.device("cpu"),
                              backend="gloo", spatial=4)
    ds = SyntheticImageDataset(8, (16, 16), seed=3)
    with pytest.raises(ValueError, match="WRONG below 2"):
        CycleGANEngine(ds, ds, str(tmp_path / "c"), 4, (16, 16), device=torch.device("cpu"),
                       base_width=8, n_res_blocks=1, mesh=group)
    two = meshlib.DataGroup(pg=None, rank=0, world=2, device=torch.device("cpu"),
                            backend="gloo", spatial=2)
    with pytest.raises(ValueError, match="spatial=False"):
        CycleGANEngine(ds, ds, str(tmp_path / "c"), 4, (96, 96), device=torch.device("cpu"),
                       base_width=8, n_res_blocks=1, mesh=two, spatial=False)
    assert not os.path.exists(tmp_path / "c")


def test_partition_leaves_the_patchgan_layers_whole():
    """partition gives the PatchGAN the group (it gathers its input's rows)
    and its layers none; the generator's layers all take it."""
    cfg = tcyc_model.CycleGANConfig(image_size=(96, 96, 3), base_width=8, n_res_blocks=1)
    gen, _, disc, _ = tcyc_model.make_models(cfg)
    group = meshlib.DataGroup(pg=None, rank=1, world=2, device=torch.device("cpu"),
                              backend="gloo", spatial=2)
    for m in (gen, disc):
        tl.partition(m, group)
    assert disc.group is group
    assert all(m.group is None for m in disc.modules() if m is not disc and hasattr(m, "group"))
    assert all(m.group is group for m in gen.modules() if hasattr(m, "group"))
    tl.partition(disc, None)
    assert disc.group is None
