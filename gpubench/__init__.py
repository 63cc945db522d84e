"""The benchmark of the PyTorch port (``reduced_3dgs_torch``) on an NVIDIA
card: ``python -m gpubench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. See ``gpubench/README.md``."""
