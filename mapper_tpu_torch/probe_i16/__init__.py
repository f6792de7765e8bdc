"""The int16 probe kernels (P1-P9) of `benchmarks/probe_i16`, as unit kernels
over the banded DP step's device functions: `probes.run(stage, body, x)`,
and `python -m mapper_tpu_torch.probe_i16 <stage>`."""
