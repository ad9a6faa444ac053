"""epipolarpose_tpu_torch — the PyTorch/CUDA port of ``epipolarpose_tpu``.

The JAX package beside this one is the reference; this package runs the
same configs on an NVIDIA H100 (Hopper, ``sm_90a``). It imports ``torch``
and never ``jax`` or ``epipolarpose_tpu``: what it needs from there it
keeps as its own copy. Layout mirrors the reference package:

- config:    the YAML schema and ``load_config`` / ``update_config``.
- geometry:  crop affines, ``transform_preds``, flip-back of model outputs.
- ops:       soft-argmax decode (``softmax_integral``), MPJPE metrics.
- models:    ``PoseResNet`` as an ``nn.Module`` (NCHW), and the weight
             bridge from the reference package's variables.
- core:      the eval step (flip test, decode, ``transform_preds``) and
             ``validate``.
- kernels:   hand-written CUDA kernels (``csrc/*.cu``) built with ``nvcc``
             into one shared library bound through ``ctypes``; every kernel
             keeps its plain PyTorch version beside it.
- tools:     ``profile_step --conv1x1``, the 1x1-conv matmul+stats bench.

Entry points take a ``device`` argument that defaults to ``"cuda"``; the
CPU runs only when the caller asks for it.
"""

__version__ = "0.1.0"
