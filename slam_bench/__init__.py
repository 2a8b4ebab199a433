"""The benchmark of the PyTorch and CUDA port (``python3 slam_bench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``)."""
