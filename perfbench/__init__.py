"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one-shot
FedGenGMM and DEM fits on the H100. ``python3 perfbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` runs one cell once."""
