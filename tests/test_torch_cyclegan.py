"""Port CycleGAN generator/discriminator vs the flax models, bridged weights.

Forward parity at float32 on the CPU, at the tiny configuration of
tests/test_cyclegan.py (96x96, base_width 8, 2 res blocks): the resnet
generator (with the 3x3 stride-2 ConvTranspose crop and the norm before the
tanh) and the PatchGAN discriminator, both with the corrected per-channel
InstanceNorm and with the `quirk_axis1` form. Tolerance 1e-4 abs + rel on
O(1) outputs, as tests/test_torch_sndcgan.py: a deep conv stack summed in
another order drifts by ~1e-6; a layout, padding or crop error is O(1).
Also: the discriminator's minimum-size errors, and the bridge round trip
of a whole CycleGAN train state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegeneration_tpu.models import cyclegan as jm
from imagegeneration_tpu.train import cyclegan_step as jstep
from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.models import cyclegan as tm
from imagegeneration_tpu_torch.models.cyclegan import CycleGANConfig
from imagegeneration_tpu_torch.train import cyclegan_step as tstep

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
IMAGE = (96, 96, 3)


def _configs(quirk_axis1=False, image=IMAGE):
    kw = dict(image_size=image, base_width=8, n_res_blocks=2, quirk_axis1=quirk_axis1)
    return jm.CycleGANConfig(**kw), CycleGANConfig(**kw)


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("quirk_axis1", [False, True])
def test_generator_forward_matches_flax(quirk_axis1):
    jcfg, tcfg = _configs(quirk_axis1)
    x = np.random.default_rng(0).uniform(-1, 1, (2, *IMAGE)).astype(np.float32)
    gen_j = jm.Generator(jcfg)
    v = jax.device_get(gen_j.init(jax.random.key(0), jnp.zeros((1, *IMAGE))))
    want = gen_j.apply(v, jnp.asarray(x))
    gen_t = tm.Generator(tcfg)
    bridge.load_flax_variables(gen_t, v)
    with torch.no_grad():
        got = gen_t(_nchw(x))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 96, 96)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("quirk_axis1", [False, True])
def test_discriminator_forward_matches_flax(quirk_axis1):
    jcfg, tcfg = _configs(quirk_axis1, image=(128, 128, 3))
    x = np.random.default_rng(1).uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    disc_j = jm.Discriminator(jcfg)
    v = jax.device_get(disc_j.init(jax.random.key(1), jnp.zeros((1, 128, 128, 3))))
    want = disc_j.apply(v, jnp.asarray(x))
    disc_t = tm.Discriminator(tcfg)
    bridge.load_flax_variables(disc_t, v)
    with torch.no_grad():
        got = disc_t(_nchw(x))
    assert got.shape == (2, 1, 3, 3) and want.shape == (2, 3, 3, 1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("size,match", [(64, "smaller than the 4x4 head"),
                                        (32, "before conv3")])
def test_discriminator_min_size_errors(size, match):
    """The VALID 4x4 stack needs >= 94px; both frameworks refuse smaller
    inputs with the same message, the port already at construction."""
    jcfg, tcfg = _configs(image=(size, size, 3))
    with pytest.raises(ValueError, match=match):
        jm.Discriminator(jcfg).init(jax.random.key(0), jnp.zeros((1, size, size, 3)))
    with pytest.raises(ValueError, match=match):
        tm.Discriminator(tcfg)
    disc = tm.Discriminator(_configs(image=(128, 128, 3))[1])
    with pytest.raises(ValueError, match=match):
        disc(torch.zeros(1, 3, size, size))


def _random_like(tree, rng):
    return jax.tree.map(lambda a: rng.normal(size=np.shape(a)).astype(np.float32), tree)


def test_bridge_round_trip_of_a_cyclegan_state():
    jcfg, tcfg = _configs()
    s = jax.device_get(jstep.init_state(jstep.CycleGANTrainConfig(model=jcfg)))
    rng = np.random.default_rng(2)
    want = {"step": np.asarray(7)}
    for key in ("gg", "gf", "dx", "dy"):
        params = getattr(s, f"{key}_params")
        want[f"{key}_params"] = _random_like(params, rng)
        want[f"{key}_opt"] = {"count": np.asarray(7), "mu": _random_like(params, rng),
                              "nu": _random_like(params, rng)}
    state = tstep.init_state(tstep.CycleGANTrainConfig(model=tcfg), "cpu")
    bridge.load_jax_cyclegan_state(state, want)
    got = bridge.jax_cyclegan_state(state)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    # The layouts the bridge names: ConvT unflipped (kh, kw, in, out), the
    # CycleGAN to_rgb a plain Conv_0, InstanceNorm leaves with no inner module.
    p = want["gg_params"]
    assert set(p["up0"]) == {"ConvTranspose_0"} and set(p["to_rgb"]) == {"Conv_0"}
    assert set(p["res1"]["in2"]) == {"scale", "bias"}
    w = state.gen_g.up0.weight.detach().numpy()
    np.testing.assert_array_equal(w, p["up0"]["ConvTranspose_0"]["kernel"][::-1, ::-1]
                                  .transpose(2, 3, 0, 1))
    assert len(list(state.gen_g.parameters())) == len(jax.tree.leaves(p)) == 40
