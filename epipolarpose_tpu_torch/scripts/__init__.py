"""The port's command-line entry points: ``train``, ``valid``, ``demo`` and
``train_refiner``, each run as ``python -m
epipolarpose_tpu_torch.scripts.<name>`` and callable as ``main(argv)``."""
