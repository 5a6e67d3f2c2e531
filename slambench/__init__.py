"""The benchmark of the PyTorch and CUDA port (hslam_tpu_torch): see
run.py for a run, BENCHMARK.json at the repository's root for the cells."""
