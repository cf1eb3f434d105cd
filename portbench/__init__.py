"""The benchmark of rssync_tpu_torch, the PyTorch + CUDA port, on one
NVIDIA H100: whole rendered 2.7K GoPro-like clips synced, each request
checked against a plain reference.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json at the checkout's root lists the cells; see harness.py.
"""
