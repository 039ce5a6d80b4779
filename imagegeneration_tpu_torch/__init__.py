"""imagegeneration_tpu_torch — the PyTorch + CUDA port of imagegeneration_tpu.

The JAX package `imagegeneration_tpu` stays the reference; this package does
the same work in PyTorch on one NVIDIA H100 (Hopper, sm_90a). It imports
`torch` and never `jax`, `flax`, `optax`, `orbax` or anything of the JAX
package. Every TPU (Pallas) kernel on a ported path has a hand-written CUDA
kernel here, built on first use from `csrc/` by nvcc and bound with ctypes,
with a plain PyTorch version of the same function beside it: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.

Ported so far: the SNDCGAN, CycleGAN and WGAN training paths (cli ->
engine -> step -> models -> layers -> kernels), on one card or data
parallel over several (one process per card, parallel/dp.py), their
params-only msgpack exports and figures, the SNDCGAN offline tools (the
sampling CLI and both FIDs) and the CycleGAN perception distance. Not
ported yet: spatial (image-H) partitioning across cards.

Package layout (mirrors imagegeneration_tpu):
  core/     platform (CUDA only, TF32 off; a rank's card), process groups
            (mesh.py), PRNG streams, data, metrics, checkpoints and
            flax-format msgpack exports, preview figures
  nn/       Keras-semantics layers (TF-SAME padding, Keras BatchNorm,
            glorot init, tfa InstanceNorm, the CycleGAN ResBlock) and
            spectral norm
  ops/      kernel wrappers + plain versions; native.py builds csrc/*.cu;
            sqrtm.py (the FID cross term)
  csrc/     CUDA C++ sources of the kernels
  models/   SNDCGAN, CycleGAN and WGAN generators and discriminators
  parallel/ data parallelism by hand: gradient mean, synced BatchNorm
            statistics, replication checks, the local launcher
  train/    Keras-form Adam, RMSprop, losses, the three steps and engines
  evalx/    the FIDs (discriminator features, InceptionV3) and the PD
  cli/      reference-signature entry points (trainers, sampling, FID, PD)
  tools/    profile_step, kernel timing tools for a card, the data-parallel
            dry run and 2-rank step checks
  bridge.py JAX (flax) variables <-> port state, for tests, exports and
            imports
"""

__version__ = "0.1.0"
