"""Data-parallel training of the port on the CPU: gloo ranks against JAX.

The ranks are spawned processes (parallel/dp.spawn_local, gloo, CPU, one
thread each) that import no JAX: this module imports JAX only inside the
functions the parent runs, and every worker reports whether `jax` is in its
`sys.modules`. The parent computes the JAX side.

The contract is the JAX package's own (tests/test_parallel.py, the float64
multi-step mesh tests): a data-parallel step over a global batch of B is
the one-device step on that batch. Here 2 ranks of the port, in float64,
run 4 steps and are held against the JAX one-device float64 step on the
global batch (batch 4, the mesh tests' sizes): SNDCGAN with dropout 0.5
(the mask at the global element index is what a port can get wrong),
WGAN with the weight clip and with the gradient penalty at n_critic 2 (both
cadence branches), and CycleGAN. Every metric, and the final state leaf by
leaf (parameters, BatchNorm statistics, optimizer moments), within the JAX
mesh tests' bound max(1e-8, 1e-6 * max|leaf|); the two ranks' states are
bit-equal, and equal to the port's one-process run within the same bound.
Metrics: rtol 1e-5. Both packages return them in float32 and take the
losses of float32 logits; XLA's and PyTorch's float32 log-sigmoid and
reductions differ in the last bits (measured <= 2e-6 relative).

Two leaves of the free runs are held to an absolute bound against JAX
(`ABSOLUTE`), each for the same reason: an ulp of float32 rounding that
the optimizer magnifies, where XLA and PyTorch round apart for the same
inputs. Neither is a fault of the data-parallel layer: the ranks equal
the port's one-process run bit for bit, and that run differs from JAX by
the same amount by itself.

- wgan_clip, the critic RMSprop nu of conv0_bn's bias: 16 absolute. For
  the same float32 inputs, XLA's fused CPU RMSprop and PyTorch's
  multi-tensor ops round nu and the parameters differently in the last
  bit (16% and 17% of 200,000 entries), and the WGAN trajectory amplifies
  an ulp (tests/test_torch_wgan_step.py). Measured on 2 ranks and on 2 x 2
  spatial ranks alike: 0.0469, 0.8125, 1.125 and 2.78 absolute after steps
  1-4, of values up to 2.2e6 (0.43, 0.54, 0.51 and 1.35 of the relative
  bound; the leaf passed it on another machine). The bound is 5.8x the
  last reading. A planted fault moves the leaf by 1.56e6 or more after
  step 4 (BatchNorm statistics of the rank's own rows: 2.0e6 on 2 ranks,
  1.56e6 on 2 x 2; a sum for the gradients' mean: 4.5e6), 1e5 times the
  bound. Every other leaf of the final state is within 0.79 of its
  relative bound (wgan_gp: 0.64).
- CycleGAN's two discriminator head kernels: 1e-6 absolute (0.5% of lr).
  The heads feed a float32 binary cross entropy whose cotangents XLA and
  PyTorch round differently in the last bit, and Adam moves an entry by
  lr*g/(|g| + 1e-7), so where g is near 0 an ulp of g moves the entry by
  up to lr*ulp/1e-7: measured 1.35-1.57x the relative bound after one step
  and 1.55x after four in ONE process, and up to 2.1x on 2 ranks,
  depending on the batches. Their Adam moments, and every other leaf, stay
  within the bound, and against the port's one-process run the heads do
  too. A fault of the data-parallel layer (a sum for a mean, local
  BatchNorm statistics, a wrong dropout offset, a missed all-reduce) moves
  the moments by a factor of 2 or more.

Beside the free runs, the two WGAN runs are replayed (`REPLAYED`): each
step of the ranks starts from the JAX state before it, and every step's
state is held to the JAX state after it within the relative bound, no leaf
exempted. Measured: every leaf within 0.71 of its bound (wgan_clip) and
0.52 (wgan_gp) at every step, while a planted fault puts the worst leaf at
4e5 to 6e6 of it.

Then the engines, the CLIs and the dry run: SNDCGANEngine on 2 ranks,
streamed and resident, against the one-process engine on the same global
batches (float64: every epoch metric within 1e-6, parameters within the
bound above), only rank 0 writing and both ranks resuming; host-sharded
WGAN and CycleGAN engines (each rank decodes only its block of the files,
both reach the same batch count, and the rows left out are reported once
per epoch); a trainer CLI with `--device cpu --mesh-data 2`; the spatial
refusals (the guard's) and the too-many-ranks one;
tools/dryrun_multichip with n = 2.
"""

from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import os
import sys

import numpy as np
import pytest
import torch

from imagegeneration_tpu_torch.core import mesh as meshlib
from imagegeneration_tpu_torch.models.cyclegan import CycleGANConfig
from imagegeneration_tpu_torch.models.sndcgan import SNDCGANConfig
from imagegeneration_tpu_torch.models.wgan import WGANConfig
from imagegeneration_tpu_torch.nn import layers as tl
from imagegeneration_tpu_torch.ops import dropout as tdrop
from imagegeneration_tpu_torch.parallel import dp
from imagegeneration_tpu_torch.tools import dp_parity
from imagegeneration_tpu_torch.train import cyclegan_step as tcyc
from imagegeneration_tpu_torch.train import sndcgan_step as tsnd
from imagegeneration_tpu_torch.train import wgan_step as twgan

torch.set_num_threads(1)

WORLD, STEPS, B = 2, 4, 4
N_SITES = tsnd.N_SITES
KW = np.random.default_rng(2024).integers(0, 2**32, (N_SITES, 2), dtype=np.uint64)


def _spawn(fn, *args):
    return dp.spawn_local(fn, WORLD, "cpu", args=args, num_threads=1, timeout=600)


def _leaf_bound(b: np.ndarray) -> float:
    return max(1e-8, 1e-6 * float(np.abs(b).max(initial=0.0)))


def _tree_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree, np.float64)


def _worst(got, want, skip=()):
    """(largest |got - want| / bound over the leaves but `skip`, its leaf)."""
    g, w = dict(_tree_leaves(got)), dict(_tree_leaves(want))
    assert sorted(g) == sorted(w)
    ratios = {k: float(np.abs(g[k] - w[k]).max(initial=0.0)) / _leaf_bound(w[k])
              for k in w if k not in skip}
    key = max(ratios, key=ratios.get)
    return ratios[key], key


# ------------------------------------------------------------ mesh pieces
def test_process_row_range_and_refusals():
    group = meshlib.DataGroup(pg=None, rank=1, world=2, device=torch.device("cpu"),
                              backend="gloo")
    assert meshlib.process_row_range(group, 8) == (4, 8)
    assert meshlib.process_row_range(None, 8) == (0, 8)
    with pytest.raises(ValueError, match="not divisible"):
        meshlib.process_row_range(group, 5)
    with pytest.raises(RuntimeError, match="initialized process group"):
        meshlib.make_mesh(meshlib.MeshConfig(data=2, spatial=2), torch.device("cpu"))
    # more ranks than cards (none on a CPU-only host): refused, never shrunk
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="need 2 cards"):
            dp.local_devices(2, "cuda")
    with pytest.raises(ValueError, match="one rank per card"):
        dp.spawn_local(dp_parity.run_steps, 2, backend="nccl", devices=["cuda:0", "cuda:0"])
    assert dp.local_devices(3, "cpu") == [torch.device("cpu")] * 3
    assert not group.is_main and not meshlib.launched_distributed()
    assert meshlib.maybe_init_distributed("cpu") is False


def _sleep_worker(group, seconds):
    import time

    time.sleep(seconds)
    return group.rank


@pytest.mark.parametrize("timeout", [None, 1.0])
def test_spawn_local_waits_without_a_deadline(timeout):
    """A training run (timeout None, as the CLIs launch) outlives any
    deadline while its ranks live; a deadline ends ranks still working."""
    if timeout is None:
        assert dp.spawn_local(_sleep_worker, 1, "cpu", args=(6.0,), num_threads=1) == [0]
    else:
        with pytest.raises(RuntimeError, match="no result from ranks"):
            dp.spawn_local(_sleep_worker, 1, "cpu", args=(6.0,), num_threads=1,
                           timeout=timeout)


def _token_worker(group, token):
    """Rank 0's token as every rank of the group sees it, and the group's
    sum of (rank + 1)."""
    t = torch.tensor([token if group.rank == 0 else -1], dtype=torch.int64)
    torch.distributed.broadcast(t, src=0)
    total = torch.tensor([group.rank + 1], dtype=torch.int64)
    torch.distributed.all_reduce(total)
    return int(t), int(total), group.world


def test_groups_started_at_once_keep_their_own_rendezvous():
    """Two spawn_local groups started at the same moment (as test workers
    do side by side) each meet only their own ranks: each parent serves
    its group's store on a port bound as it is chosen."""
    with concurrent.futures.ThreadPoolExecutor(2) as threads:
        runs = [threads.submit(dp.spawn_local, _token_worker, world, "cpu",
                               args=(token,), num_threads=1, timeout=120)
                for world, token in ((2, 11), (3, 22))]
        got = [r.result() for r in runs]
    assert got == [[(11, 3, 2)] * 2, [(22, 6, 3)] * 3]


@pytest.mark.parametrize("shape", [(4, 5, 7, 3), (6, 16, 16, 64)])
def test_plain_dropout_base_is_the_jax_global_mask(shape):
    """Rank r of `world` rows-blocks: the plain mask with base r*b*H*W*C is
    bit-equal to the JAX hash1 mask of the GLOBAL (B, H, W, C) array at those
    rows, and the fused forward/backward of the rows equals the full
    batch's rows."""
    import jax.numpy as jnp

    from imagegeneration_tpu.ops import bitdropout

    cut = tdrop.dropout_cut(0.5)
    kw = np.random.default_rng(sum(shape)).integers(0, 2**32, 2, dtype=np.uint64)
    want = np.asarray(bitdropout._hash_mask(
        jnp.asarray(kw.astype(np.uint32)), jnp.ones(shape, jnp.float32), cut,
        (256 - cut) / 256.0, rounds=1)) != 0
    kwt = torch.from_numpy(kw.astype(np.int64))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).permute(0, 3, 1, 2)
    x = x.contiguous(memory_format=torch.channels_last)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    g = g.contiguous(memory_format=torch.channels_last)
    full_y = tdrop.fwd_plain(x, kwt, cut)
    full_dx = tdrop.bwd_plain(x, g, kwt, cut)
    for world in (2, shape[0]):
        b = shape[0] // world
        per_row = int(np.prod(shape[1:]))
        for r in range(world):
            got = tdrop.hash_keep_mask(kwt, b * per_row, cut, base=r * b * per_row)
            np.testing.assert_array_equal(got.view(b, *shape[1:]).numpy(),
                                          want[r * b:(r + 1) * b])
            rows = slice(r * b, (r + 1) * b)
            xr = x[rows].detach().requires_grad_(True)
            y = tdrop.leaky_relu_dropout(xr, kwt, 0.5, rows=(r * b, shape[0]))
            y.backward(g[rows])
            assert torch.equal(y.detach(), full_y[rows])
            assert torch.equal(xr.grad, full_dx[rows])


def test_index_range_is_bounded_by_the_global_count():
    assert tdrop.check_index_range(10, 30, 40) == 40
    with pytest.raises(ValueError, match="2\\*\\*32"):
        tdrop.check_index_range(2**20, 2**31, 2**32)
    with pytest.raises(ValueError, match="outside"):
        tdrop.check_index_range(20, 30, 40)


def _bn_worker(group, x, w, scale, bias):
    lo, hi = meshlib.process_row_range(group, x.shape[0])
    bn = tl.BatchNorm(x.shape[1]).double()
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    tl.partition(bn, group)
    xr = torch.from_numpy(x[lo:hi]).contiguous(memory_format=torch.channels_last)
    xr.requires_grad_(True)
    y = bn(xr, use_running_average=False)
    loss = (y * torch.from_numpy(w[lo:hi])).mean()  # this rank's mean
    dx, dscale, dbias = torch.autograd.grad(loss, [xr, bn.scale, bn.bias])
    dscale, dbias = dp.all_reduce_mean_([dscale, dbias], group)
    return {"y": y.detach().numpy(), "dx": dx.numpy(), "dscale": dscale.numpy(),
            "dbias": dbias.numpy(), "mean": bn.mean.numpy(), "var": bn.var.numpy(),
            "counts": dict(group.counts), "jax_imported": "jax" in sys.modules}


def test_synced_batch_norm_is_flax_on_the_global_batch():
    """Forward, running statistics and gradients of BatchNorm on 2 ranks
    equal flax BatchNorm on the global batch (float64). Each rank's loss is
    the mean over its rows, so its x-gradient is world x the global mean's
    at its rows, and its averaged parameter gradients are the global ones."""
    import jax
    import jax.numpy as jnp

    from imagegeneration_tpu.nn import layers as jl

    rng = np.random.default_rng(3)
    x = 2.0 + 3.0 * rng.normal(size=(4, 6, 3, 5))
    w = rng.normal(size=x.shape)
    scale, bias = rng.uniform(0.5, 1.5, 6), rng.normal(size=6)
    out = _spawn(_bn_worker, x, w, scale, bias)
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        mod = jl.BatchNorm(use_running_average=False, dtype=jnp.float64,
                           param_dtype=jnp.float64)
        xn, wn = x.transpose(0, 2, 3, 1), w.transpose(0, 2, 3, 1)
        v = mod.init(jax.random.key(0), jnp.asarray(xn))
        p = {"BatchNorm_0": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}

        def loss(p, xx):
            y, mut = mod.apply({"params": p, "batch_stats": v["batch_stats"]}, xx,
                               mutable=["batch_stats"])
            return jnp.mean(y * wn), (y, mut)

        (_, (y, mut)), (dp_, dx) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
            p, jnp.asarray(xn))
    finally:
        jax.config.update("jax_enable_x64", old)
    tol = dict(rtol=1e-12, atol=1e-12)
    for r, o in enumerate(out):
        assert not o["jax_imported"]
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_allclose(o["y"], np.asarray(y).transpose(0, 3, 1, 2)[rows], **tol)
        np.testing.assert_allclose(o["dx"] / WORLD,
                                   np.asarray(dx).transpose(0, 3, 1, 2)[rows], **tol)
        np.testing.assert_allclose(o["dscale"], np.asarray(dp_["BatchNorm_0"]["scale"]), **tol)
        np.testing.assert_allclose(o["dbias"], np.asarray(dp_["BatchNorm_0"]["bias"]), **tol)
        stats = mut["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(o["mean"], np.asarray(stats["mean"]), **tol)
        # flax's stored running variance is ~1e-8 off the float64 update (its
        # statistics start as float32 variables); y and the gradients above
        # use the batch variance itself and agree to 1e-12
        np.testing.assert_allclose(o["var"], np.asarray(stats["var"]), rtol=1e-7)
        # one forward and one backward all-reduce, one gradient all-reduce
        assert o["counts"]["stat_all_reduce"] == 2 and o["counts"]["grad_all_reduce"] == 1


# ------------------------------------------------- the f64 multi-step runs
def _jobs():
    """(name, family, port config, inputs) of the four runs."""
    rng = np.random.default_rng(13)
    im = (32, 32, 3)
    snd = tsnd.SNDCGANTrainConfig(
        model=SNDCGANConfig(image_size=im, base_width=16, dropout_rate=0.5,
                            dtype=torch.float64), batch_size=B, seed=7)
    snd_in = {"batches": rng.integers(0, 256, (STEPS, B, *im), np.uint8),
              "z": rng.uniform(-1, 1, (STEPS, B, 128)), "kw": KW.astype(np.int64)}
    rng = np.random.default_rng(11)
    wgan_in = {"batches": rng.integers(0, 256, (STEPS, B, *im), np.uint8),
               "z_fake": rng.normal(size=(STEPS, B, 128)),
               "z_gan": rng.normal(size=(STEPS, B, 128))}
    jobs = [("sndcgan", "sndcgan", snd, snd_in)]
    for name, gp in (("wgan_clip", 0.0), ("wgan_gp", 10.0)):
        cfg = twgan.WGANTrainConfig(model=WGANConfig(image_size=im, base_width=16,
                                                     dtype=torch.float64),
                                    batch_size=B, n_critic=2, seed=7, gp_lambda=gp)
        jobs.append((name, "wgan", cfg, dict(wgan_in)))
    rng = np.random.default_rng(12)
    cim = (96, 96, 3)
    cyc = tcyc.CycleGANTrainConfig(
        model=CycleGANConfig(image_size=cim, base_width=8, n_res_blocks=1,
                             dtype=torch.float64), batch_size=B, seed=7)
    jobs.append(("cyclegan", "cyclegan", cyc, {
        "batches_x": rng.integers(0, 256, (STEPS, B, *cim), np.uint8),
        "batches_y": rng.integers(0, 256, (STEPS, B, *cim), np.uint8)}))
    return jobs


def to_parent(run: dict, rank: int, per_step: bool) -> dict:
    """What a spawned process sends back of a run, and all the tests read:
    the metrics, digest and counts, and from rank 0 alone the final state
    (with `per_step`, a replay's, the state after each step too). The other
    ranks' states are rank 0's (their digests say so), and a float64 state
    of these runs pickles to ~90 MB: when every rank sent every state of
    every run, the 4 spatial ranks grew to ~7.6 GB each and their parent to
    12 GB, and the kernel's OOM killer ended a rank inside the full suite."""
    keep = {"state", "states"} if per_step else {"state"}
    return {k: v for k, v in run.items()
            if k not in ("state", "state0", "states") or (rank == 0 and k in keep)}


def _one_process_runs(jobs):
    torch.set_num_threads(1)
    return {name: to_parent(dp_parity.run_steps(None, family, cfg, inputs, init), 0, False)
            for name, family, cfg, inputs, init in jobs}


def _steps_worker(group, jobs):
    out = {name: to_parent(dp_parity.run_steps(group, family, cfg, inputs, init), group.rank,
                           isinstance(init, list))
           for name, family, cfg, inputs, init in jobs}
    return {"runs": out, "jax_imported": "jax" in sys.modules}


def _jax_state0(name):
    """The JAX initial state of a run (x64 on), as the bridge's numpy tree."""
    import jax
    import jax.numpy as jnp

    if name == "sndcgan":
        from imagegeneration_tpu.models.sndcgan import SNDCGANConfig as JM
        from imagegeneration_tpu.train import sndcgan_step as js

        def _as_dict(s):
            opt = lambda o: {"count": o.count, "mu": o.mu, "nu": o.nu}  # noqa: E731
            return {"step": s.step, "g_params": s.g_params, "g_batch_stats": s.g_batch_stats,
                    "g_opt": opt(s.g_opt), "d_params": s.d_params,
                    "d_spectral": s.d_spectral, "d_opt": opt(s.d_opt)}

        cfg = js.SNDCGANTrainConfig(model=JM(image_size=(32, 32, 3), base_width=16,
                                             dropout_rate=0.5, dtype=jnp.float64),
                                    batch_size=B, seed=7)
    elif name.startswith("wgan"):
        from imagegeneration_tpu.models.wgan import WGANConfig as JM
        from imagegeneration_tpu.train import wgan_step as js

        def _as_dict(s):
            return {"step": s.step, "critic_count": s.critic_count,
                    "g_params": s.g_params, "g_batch_stats": s.g_batch_stats,
                    "c_params": s.c_params, "c_batch_stats": s.c_batch_stats,
                    "c_opt": {"nu": s.c_opt[0].nu}, "gan_opt": {"nu": s.gan_opt[0].nu}}

        cfg = js.WGANTrainConfig(model=JM(image_size=(32, 32, 3), base_width=16,
                                          dtype=jnp.float64), batch_size=B, n_critic=2,
                                 seed=7, gp_lambda=10.0 if name == "wgan_gp" else 0.0)
    else:
        from imagegeneration_tpu.models.cyclegan import CycleGANConfig as JM
        from imagegeneration_tpu.train import cyclegan_step as js

        def _as_dict(s):
            out = {"step": s.step}
            for key in ("gg", "gf", "dx", "dy"):
                o = getattr(s, f"{key}_opt")
                out[f"{key}_params"] = getattr(s, f"{key}_params")
                out[f"{key}_opt"] = {"count": o.count, "mu": o.mu, "nu": o.nu}
            return out

        cfg = js.CycleGANTrainConfig(model=JM(image_size=(96, 96, 3), base_width=8,
                                              n_res_blocks=1, in_backend="xla",
                                              dtype=jnp.float64), batch_size=B, seed=7)
    state = js.init_state(cfg)
    return js, cfg, state, _as_dict, _as_dict(jax.device_get(state))


def _jax_run(name, inputs, js, cfg, state, as_dict):
    """Metrics per step, the final state and (WGAN) the state after each
    step of the JAX one-device step."""
    import jax

    from imagegeneration_tpu.ops import bitdropout

    step = jax.jit(js.make_train_step(cfg))
    metrics, states = [], []
    if name == "sndcgan":
        calls = []

        def fixed_kw_dropout(key, x, rate, rounds=2):
            site = len(calls) % N_SITES
            calls.append(site)
            return bitdropout._hash_dropout_vjp(
                jax.numpy.asarray(KW[site].astype(np.uint32)), x, rate, rounds)

        saved, bitdropout.hash_dropout = bitdropout.hash_dropout, fixed_kw_dropout
        try:
            for i in range(STEPS):
                state, m = step(state, inputs["batches"][i], inputs["z"][i])
                metrics.append({k: float(v) for k, v in m.items()})
        finally:
            bitdropout.hash_dropout = saved
        # traced twice: the first step turns the batch statistics float64
        assert calls[:N_SITES] == list(range(N_SITES)) and len(calls) % N_SITES == 0
    elif name.startswith("wgan"):
        for i in range(STEPS):
            state, m = step(state, inputs["batches"][i], inputs["z_fake"][i],
                            inputs["z_gan"][i])
            metrics.append({k: float(v) for k, v in m.items()})
            states.append(as_dict(jax.device_get(state)))
    else:
        for i in range(STEPS):
            state, m = step(state, inputs["batches_x"][i], inputs["batches_y"][i])
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, as_dict(jax.device_get(state)), states


def _gp_eps(cfg):
    """The JAX WGAN-GP step's own interpolation weights per step."""
    import jax

    from imagegeneration_tpu.core import rng as jrng

    stream = jrng.KeyChain(cfg.seed).stream("z")
    return np.stack([np.asarray(jax.random.uniform(
        jax.random.split(jax.random.fold_in(stream, i), 3)[2], (B, 1, 1, 1)))
        for i in range(STEPS)])


@pytest.fixture(scope="module")
def f64_runs():
    """{name: (2-rank results, one-process port result, JAX metrics, JAX
    final state, JAX states after each step)} for the free runs and, named
    `<run>_replayed`, the replayed ones. The WGAN JAX runs come first (the
    replays start from their states); the ranks and the one-process port
    run (a third spawned process) then run while the parent compiles and
    runs the other JAX steps."""
    import jax

    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        jobs, jax_side, want = [], {}, {}
        for name, family, cfg, inputs in _jobs():
            js, jcfg, state, as_dict, state0 = _jax_state0(name)
            if name == "wgan_gp":
                inputs["gp_eps"] = _gp_eps(jcfg)
            jobs.append((name, family, cfg, inputs, state0))
            if name in REPLAYED:  # each step from the JAX state before it
                want[name] = _jax_run(name, inputs, js, jcfg, state, as_dict)
                want[f"{name}_replayed"] = want[name]
                jobs.append((f"{name}_replayed", family, cfg, inputs,
                             [state0] + want[name][2][:-1]))
            jax_side[name] = (js, jcfg, state, as_dict)
        spawn = multiprocessing.get_context("spawn")
        with (concurrent.futures.ThreadPoolExecutor(1) as threads,
              concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as procs):
            ranks = threads.submit(_spawn, _steps_worker, jobs)
            one = procs.submit(_one_process_runs, jobs)
            for name, _, _, inputs, _ in jobs:
                if name not in want:
                    want[name] = _jax_run(name, inputs, *jax_side[name])
            out, one = ranks.result(), one.result()
    finally:
        jax.config.update("jax_enable_x64", old)
    assert not any(o["jax_imported"] for o in out)
    return {name: ([o["runs"][name] for o in out], one[name], *want[name])
            for name in want}


RUNS = ["sndcgan", "wgan_clip", "wgan_gp", "cyclegan"]
# runs also replayed, each step from the JAX state before it (module docstring)
REPLAYED = ("wgan_clip", "wgan_gp")
# leaves of the free runs held to an absolute bound against JAX (module docstring)
ABSOLUTE = {"cyclegan": {"/dx_params/head/Conv_0/kernel": 1e-6,
                         "/dy_params/head/Conv_0/kernel": 1e-6},
            "wgan_clip": {"/c_opt/nu/conv0_bn/BatchNorm_0/bias": 16.0}}


def check_free_run(name, got, want_metrics, want_state):
    """Every metric within rtol 1e-5 of JAX's, and the final state leaf by
    leaf within the relative bound, or `ABSOLUTE`'s for its leaves."""
    for i, (m, w) in enumerate(zip(got["metrics"], want_metrics)):
        assert set(m) == set(w)
        for k in w:
            assert m[k] == pytest.approx(w[k], rel=1e-5, abs=1e-7), f"step {i + 1} {k}"
    absolute = ABSOLUTE.get(name, {})
    g, w = dict(_tree_leaves(got["state"])), dict(_tree_leaves(want_state))
    for leaf, bound in absolute.items():
        err = np.abs(g[leaf] - w[leaf]).max()
        assert err <= bound, f"{name}: leaf {leaf} {err:.4g} off, bound {bound:g}"
    ratio, leaf = _worst(got["state"], want_state, skip=tuple(absolute))
    assert ratio <= 1.0, f"{name}: leaf {leaf} at {ratio:.3g} of its bound"


def check_replay(name, got, want_states):
    """Every step's state, each from the JAX state before it, leaf by leaf
    within the relative bound."""
    assert len(got["states"]) == len(want_states) == STEPS
    for i, (g_state, w_state) in enumerate(zip(got["states"], want_states)):
        ratio, leaf = _worst(g_state, w_state)
        assert ratio <= 1.0, f"{name} step {i + 1}: leaf {leaf} at {ratio:.3g} of its bound"


@pytest.mark.parametrize("name", RUNS)
def test_two_ranks_match_the_jax_step_on_the_global_batch(f64_runs, name):
    ranks, _, want_metrics, want_state, _ = f64_runs[name]
    check_free_run(name, ranks[0], want_metrics, want_state)


@pytest.mark.parametrize("name", REPLAYED)
def test_two_ranks_match_each_jax_step_replayed_from_its_state(f64_runs, name):
    ranks, _, _, _, want_states = f64_runs[f"{name}_replayed"]
    check_replay(name, ranks[0], want_states)


@pytest.mark.parametrize("name", RUNS + [f"{n}_replayed" for n in REPLAYED])
def test_two_ranks_are_bit_equal_and_equal_one_process(f64_runs, name):
    """The ranks' digests are equal; the collectives are one gradient
    all-reduce per optimizer apply and one metric all-reduce; the state
    equals the one-process port run within the mesh bound."""
    ranks, one, *_ = f64_runs[name]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert ranks[0]["state"].keys() == one["state"].keys()
    applies = {"sndcgan": 3 * STEPS, "cyclegan": 4 * STEPS,
               "wgan_clip": 2 * STEPS + STEPS // 2, "wgan_gp": 2 * STEPS + STEPS // 2}
    for r in ranks:
        assert r["collectives"]["grad_all_reduce"] == applies[name.removesuffix("_replayed")]
        assert r["collectives"]["metric_all_reduce"] == 1
    ratio, leaf = _worst(ranks[0]["state"], one["state"])
    assert ratio <= 1.0, f"{name}: leaf {leaf} at {ratio:.3g} of its bound"
    for m, w in zip(ranks[0]["metrics"], one["metrics"]):
        for k in w:
            assert m[k] == pytest.approx(w[k], rel=1e-6, abs=1e-9), k


# ----------------------------------------------------------- the engines
def _engine_worker(group, root, data, streamed, phases):
    """SNDCGANEngine phases [(epochs, continue_)] on this rank; returns the
    metrics, digests and parameters, and which writers this rank called."""
    from imagegeneration_tpu_torch.core import checkpoint as ckptlib
    from imagegeneration_tpu_torch.core import data as datalib
    from imagegeneration_tpu_torch.core import metrics as metricslib
    from imagegeneration_tpu_torch.train import sndcgan_engine

    writes = {"checkpoint": 0, "export": 0, "losses": 0, "perf": 0}
    if group is not None:  # a spawned rank: patch its own modules only
        if streamed:
            datalib.resident_budget = lambda device: 0

        def counting(name, fn):
            def wrapped(*a, **k):
                writes[name] += 1
                return fn(*a, **k)
            return wrapped

        ckptlib.CheckpointManager.save = counting("checkpoint", ckptlib.CheckpointManager.save)
        ckptlib.export_params = counting("export", ckptlib.export_params)
        metricslib.LossHistory.save = counting("losses", metricslib.LossHistory.save)
        metricslib.write_metrics_jsonl = counting("perf", metricslib.write_metrics_jsonl)
    dataset = datalib.SyntheticImageDataset(*data)
    out = []
    for epochs, cont in phases:
        engine = sndcgan_engine.SNDCGANEngine(
            root, dataset, 4, continue_=cont, image_size=(16, 16, 3), base_width=16,
            dtype=torch.float64, device=torch.device("cpu"), live_output=f"{root}/live",
            mesh=group)
        start = engine.start_epoch
        engine.train(epochs, 1)
        out.append({"start": start, "resident": engine.resident,
                    "metrics": engine.last_epoch_metrics, "digest": engine.last_digest,
                    "params": {k: v.detach().numpy().copy()
                               for k, v in engine.state.gen.state_dict().items()}})
    rank = 0 if group is None else group.rank
    return {"rank": rank, "phases": out, "writes": writes, "jax_imported": "jax" in sys.modules}


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    data = (12, (16, 16), 5)  # 3 global batches of 4 per epoch
    phases = [(1, False), (2, True)]
    from imagegeneration_tpu_torch.core import data as datalib

    out = {}
    for streamed in (True, False):
        root = tmp_path_factory.mktemp("dp_engine")
        with concurrent.futures.ThreadPoolExecutor(1) as threads:
            ranks = threads.submit(_spawn, _engine_worker, str(root / "two"), data, streamed,
                                   phases)
            with pytest.MonkeyPatch.context() as mp:
                if streamed:
                    mp.setattr(datalib, "resident_budget", lambda device: 0)
                one = _engine_worker(None, str(root / "one"), data, streamed, phases)
            ranks = ranks.result()
        out["streamed" if streamed else "resident"] = (ranks, one, root)
    return out


@pytest.mark.parametrize("mode", ["streamed", "resident"])
def test_engine_on_two_ranks_equals_one_process(engine_runs, mode):
    ranks, one, _ = engine_runs[mode]
    assert all(not r["jax_imported"] for r in ranks)
    for p, (a, b, w) in enumerate(zip(ranks[0]["phases"], ranks[1]["phases"], one["phases"])):
        assert a["resident"] == b["resident"] == w["resident"] == (mode == "resident")
        assert a["start"] == b["start"] == w["start"] == p  # both ranks resume
        assert a["digest"] == b["digest"]
        for k, v in w["metrics"].items():
            assert a["metrics"][k] == pytest.approx(v, rel=1e-6, abs=1e-9), (p, k)
        for k, v in w["params"].items():
            assert np.abs(a["params"][k] - v).max() <= _leaf_bound(v), (p, k)


def test_engine_only_rank0_writes(engine_runs):
    ranks, _, root = engine_runs["streamed"]
    # epochs 0 and 1 (the second after a resume), each checkpointed and exported
    assert ranks[0]["writes"] == {"checkpoint": 2, "export": 4, "losses": 2, "perf": 2}
    assert set(ranks[1]["writes"].values()) == {0}
    with open(root / "two" / "perf.jsonl") as f:
        perf = [json.loads(line) for line in f]
    assert [p["epoch"] for p in perf] == [0, 1] and {p["ranks"] for p in perf} == {2}


def _write_folder(folder, n, seed, size=(20, 28)):
    import cv2

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        cv2.imwrite(os.path.join(folder, f"img{i:03d}.png"),
                    rng.integers(0, 256, (*size, 3), dtype=np.uint8))


def _sharded_worker(group, family, root, folders):
    if family == "wgan":
        from imagegeneration_tpu_torch.train.wgan_engine import WGANEngine

        engine = WGANEngine(folders[0], (16, 16, 3), 4, 2, path_like=root, base_width=16,
                            device=torch.device("cpu"), mesh=group, host_sharded_data=True,
                            profile=True)
        datasets = [engine.dataset]
        engine.train(2)
    else:
        from imagegeneration_tpu_torch.train.cyclegan_engine import CycleGANEngine

        engine = CycleGANEngine(*folders, root, 4, (96, 96), device=torch.device("cpu"),
                                base_width=8, n_res_blocks=1, mesh=group,
                                host_sharded_data=True, profile=True)
        datasets = [engine.loader.ds_x, engine.loader.ds_y]
        engine.train(2, 1)
    return {"rank": group.rank, "sizes": [len(d) for d in datasets],
            "shard_sizes": [list(map(int, d.shard_sizes)) for d in datasets],
            "files": [[str(f) for f in d.files] for d in datasets],
            "num_batches": engine.num_batches, "dropped": engine.feed.dropped,
            "digest": engine.last_digest, "jax_imported": "jax" in sys.modules}


@pytest.mark.parametrize("family", ["wgan", "cyclegan"])
def test_host_sharded_engines_partition_the_files(family, tmp_path, capfd):
    """11 files over 2 ranks: shards of 5 and 6 files, each decoded by its
    rank only; both ranks take the smaller shard's 2 batches of 2 rows, and
    the 3 rows of each domain the epoch leaves out are printed once per
    epoch by rank 0 (the reference's num_local_batches silently drops them,
    and rows= with drop_remainder=False mis-partitions). With profile=True
    every rank writes its own trace of the run's second epoch."""
    folders = [str(tmp_path / f"d{i}") for i in range(1 if family == "wgan" else 2)]
    for i, f in enumerate(folders):
        _write_folder(f, 11, i)
    out = _spawn(_sharded_worker, family, str(tmp_path / "run"), folders)
    printed = capfd.readouterr().out
    n_domains = len(folders)
    for r, o in enumerate(out):
        assert not o["jax_imported"]
        assert o["shard_sizes"] == [[5, 6]] * n_domains
        assert o["sizes"] == [[5, 6][r]] * n_domains
        assert o["num_batches"] == 2
        assert o["dropped"] == 3 * n_domains
    for d in range(n_domains):
        a, b = out[0]["files"][d], out[1]["files"][d]
        assert not set(a) & set(b) and len(a) + len(b) == 11
    assert out[0]["digest"] == out[1]["digest"]
    assert printed.count(f"host-sharded data: {3 * n_domains} rows left out this epoch") == 2
    second = 2 if family == "wgan" else 1  # WGAN counts epochs from 1
    assert sorted(os.listdir(tmp_path / "run" / "traces")) == [
        f"epoch_{second}.rank{r}.json" for r in (0, 1)]


def test_trainer_cli_runs_two_cpu_ranks(tmp_path):
    from imagegeneration_tpu_torch.cli import sndcgan_trainer

    folder = tmp_path / "data" / "class0"
    _write_folder(str(folder), 8, 4)
    out = tmp_path / "run"
    sndcgan_trainer.main(["4", "0", "-x", str(tmp_path / "data"), "-d", str(out),
                          "--height", "16", "--width", "16", "--device", "cpu",
                          "--mesh-data", "2", "-lo", str(tmp_path / "live")])
    with open(out / "perf.jsonl") as f:
        perf = [json.loads(line) for line in f]
    assert len(perf) == 1 and perf[0]["ranks"] == 2 and perf[0]["images_per_sec"] > 0
    assert (out / "models" / "generator" / "gen_model-0.msgpack").exists()


@pytest.mark.parametrize("trainer", ["sndcgan_trainer", "wgan_trainer", "cyclegan_trainer"])
def test_trainer_clis_refuse_spatial_and_missing_cards(trainer, tmp_path, capsys):
    """Each trainer refuses what the guard refuses at 16 rows: 1 row per
    shard of 2 at H/8 (SNDCGAN, WGAN), of 4 at H/4 (CycleGAN);
    tests/test_torch_spatial.py trains the accepted ones."""
    import importlib

    cli = importlib.import_module(f"imagegeneration_tpu_torch.cli.{trainer}")
    base = ["4", "1", "-d", str(tmp_path / "run")]
    spatial = "4" if trainer == "cyclegan_trainer" else "2"
    with pytest.raises(SystemExit):
        cli.main(base + ["--mesh-data", "2", "--mesh-spatial", spatial, "--device", "cpu",
                         "--height", "16", "--width", "16"])
    err = capsys.readouterr().err
    assert "WRONG below 2" in err
    if torch.cuda.device_count() < 2:  # --device cuda: refused, never shrunk
        with pytest.raises(RuntimeError, match="need 2 cards"):
            cli.main(base + ["--mesh-data", "2"])


def test_dryrun_multichip_two_ranks():
    from imagegeneration_tpu_torch.tools import dryrun_multichip

    out = dryrun_multichip.dryrun_multichip(2)
    assert out["step"] == 1 and out["grad_all_reduces"] == 3
    assert not out["jax_imported"] and np.isfinite(out["metrics"]["g_loss"])


def _free_port() -> int:
    """A port free at the time of the call, for the torchrun-like launch
    below (another process may bind it before the ranks do)."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_trainer_cli_under_a_torchrun_environment(tmp_path):
    """torchrun's contract: each process gets RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT and is one rank; --mesh-data must equal
    WORLD_SIZE."""
    import subprocess

    folder = tmp_path / "data"
    _write_folder(str(folder), 8, 6)
    out = tmp_path / "run"
    port = str(_free_port())
    cmd = [sys.executable, "-m", "imagegeneration_tpu_torch.cli.wgan_trainer", "4", "1",
           "-x", str(folder), "-d", str(out), "--height", "16", "--width", "16",
           "--n-critic", "1", "--device", "cpu", "--mesh-data", "2"]
    procs = [subprocess.Popen(cmd, env={**os.environ, "RANK": str(r), "LOCAL_RANK": str(r),
                                        "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
                                        "MASTER_PORT": port, "OMP_NUM_THREADS": "1"},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "Initialized WGAN SUCCESS!" in outs[0][0] and "WGAN" not in outs[1][0]
    with open(out / "perf.jsonl") as f:
        perf = [json.loads(line) for line in f]
    assert len(perf) == 1 and perf[0]["ranks"] == 2


def test_trainer_cli_refuses_a_mesh_other_than_the_launch(tmp_path, capsys, monkeypatch):
    from imagegeneration_tpu_torch.cli import sndcgan_trainer

    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "29500")):
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit):
        sndcgan_trainer.main(["4", "0", "-d", str(tmp_path), "--device", "cpu",
                              "--mesh-data", "3"])
    assert "must equal WORLD_SIZE 2" in capsys.readouterr().err
