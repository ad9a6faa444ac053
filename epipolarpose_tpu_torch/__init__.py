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
             convention), the refinement unit ``PoseRefiner``, and the
             weight bridge from the reference package's variables.
- data:      the datasets (H36M, MPII, the synthetic rig and skeleton
             poses), the numpy crop warp, the native loader's binding and
             ``epoch_loader``.
- core:      the train step (``integral``: soft-argmax and L1;
             ``gaussian``: heatmap MSE and accuracy; backward, Adam or
             SGD) with its ``TrainState`` and ``train`` loop; the eval step
             (flip test, decode, ``transform_preds``) and ``validate``; the
             self-supervised step (frozen 2D teacher, undistortion,
             triangulation, reprojection, the student's step); the
             checkpoints (reference ``.pth.tar`` files), the run's logger,
             and the refinement unit's training.
- graphs:    CUDA graphs of whole steps (capture once, replay per
             super-batch; ``host_op`` for the ops that read back to the
             host) behind ``TPU.FUSED_STEPS``.
- kernels:   hand-written CUDA kernels (``csrc/*.cu``: soft-argmax forward
             and backward, matmul + BN statistics, triangulation) built with
             ``nvcc`` into one shared library bound through ``ctypes``;
             every kernel keeps its plain PyTorch version beside it.
- utils:     debug images as PNG, drawn in numpy.
- scripts:   the CLIs ``train``, ``valid``, ``demo``, ``train_refiner``
             (``python -m epipolarpose_tpu_torch.scripts.<name>``).
- tools:     the user's tools ``export_model`` (a ``torch.export``
             serving artifact whose decode is the registered soft-argmax
             op; ``load_exported``), ``export_torch`` (a reference
             ``.pth.tar``), ``prepare_h36m`` (H36M annotation releases)
             and ``dualcrop_headroom`` (the half-res teacher crop);
             ``profile_step --step`` (the train step and its parts),
             ``--conv1x1`` (the 1x1-conv matmul+stats bench),
             ``bench_triangulate``, ``ss_convergence`` (the SS loop's MPJPE
             curve) and ``trace_summary`` (a profiler trace's top kernels
             and idle share).

Entry points take a ``device`` argument that defaults to ``"cuda"``; the
CPU runs only when the caller asks for it.
"""

__version__ = "0.1.0"
