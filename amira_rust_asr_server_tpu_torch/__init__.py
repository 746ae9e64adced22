"""amira_rust_asr_server_tpu_torch — the PyTorch / CUDA port of the ASR server.

The JAX package ``amira_rust_asr_server_tpu`` beside it is the reference;
this package mirrors its module names so each module's counterpart is easy
to find, and serves the same HTTP surface from PyTorch on an NVIDIA GPU
(Hopper, ``sm_90a``). The two device kernels of the batch path are written
by hand in CUDA C++ (``csrc/``), built with ``nvcc`` at first use and bound
with ``ctypes`` (``ops/kernels/``); everything else is plain PyTorch.

Importing the package needs neither ``nvcc`` nor a GPU, and imports neither
``jax`` nor any module of the JAX package. The reference's leaf modules
(``constants``, ``config``, ``errors``, ``vocab``, ``reliability``, the
spoken-digits audio of ``testing``) have copies here. The port reads a
config or vocabulary by its fields and methods alone, so the tests may hand
it either package's objects.

Layout:

- ``device``       — the device rule (``Config.inference_backend``)
- ``models``       — presets, conformer encoder, prediction net + joint
- ``convert``      — JAX param pytree -> the port's state dict
- ``ops``          — log-mel features, greedy label-looping decode, kernels
- ``runtime``      — shape-bucketed pipeline and continuous batcher
- ``server``       — aiohttp front-end (``python -m ...server``)
"""

__version__ = "0.1.0"
