"""epipolarpose_tpu_torch — the PyTorch/CUDA port of ``epipolarpose_tpu``.

The JAX package beside this one is the reference; this package runs the
same configs on an NVIDIA H100 (Hopper, ``sm_90a``). It imports ``torch``
and never ``jax`` or ``epipolarpose_tpu``: what it needs from there it
keeps as its own copy. Layout mirrors the reference package:

- config:    the YAML schema and ``load_config`` / ``update_config``.
- geometry:  crop affines, ``transform_preds``, flip-back of model outputs;
             the H36M camera model (projection, undistortion); batched
             DLT triangulation (``fast``, ``eigh``, ``svd``). Elementwise
             float32, never TF32.
- ops:       soft-argmax decode (``softmax_integral``, differentiable),
             integral targets, the integral L1 loss; Gaussian heatmap
             targets, the argmax decode, the heatmap MSE and accuracy;
             MPJPE metrics.
- models:    ``PoseResNet`` as an ``nn.Module`` (NCHW, flax's BatchNorm
             convention), and the weight bridge from the reference
             package's variables.
- data:      the synthetic multi-view rig and skeleton poses.
- core:      the train step (``integral``: soft-argmax and L1;
             ``gaussian``: heatmap MSE and accuracy; backward, Adam or
             SGD) with its ``TrainState`` and ``train`` loop; the eval step
             (flip test, decode, ``transform_preds``) and ``validate``; the
             self-supervised step (frozen 2D teacher, undistortion,
             triangulation, reprojection, the student's step).
- kernels:   hand-written CUDA kernels (``csrc/*.cu``: soft-argmax forward
             and backward, matmul + BN statistics, triangulation) built with
             ``nvcc`` into one shared library bound through ``ctypes``;
             every kernel keeps its plain PyTorch version beside it.
- tools:     ``profile_step --step`` (the train step and its parts) and
             ``--conv1x1`` (the 1x1-conv matmul+stats bench).

Entry points take a ``device`` argument that defaults to ``"cuda"``; the
CPU runs only when the caller asks for it.
"""

__version__ = "0.1.0"
