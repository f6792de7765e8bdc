"""The benchmark of the PyTorch and CUDA port (`mapper_tpu_torch`): whole
CLI runs, one sample after another, judged against a plain reference.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

See `portbench/README.md`."""
