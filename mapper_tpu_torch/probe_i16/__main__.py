"""Run one stage of the int16 probes on the JAX probes' own input
(arange(T * B) % 100, [64, 128]):

    python -m mapper_tpu_torch.probe_i16 <stage>     # stage: a b c d e f g h i

The device comes from MAPPER_TPU_TORCH_DEVICE (default cuda).  On the card
every body's kernel is compared with its plain PyTorch version, exactly; on
the CPU the plain version runs alone.  Where the JAX stage checks against
numpy (d, f), the result is compared with that too.  Prints
`<body>: OK exact` for a body that was compared and agreed, `<body>: OK`
for one that ran with nothing to compare, and MISMATCH or FAIL otherwise.
Exits 1 if any body failed or differed, or if no CUDA device is available
for a cuda run; 2 on a usage error.
"""

from __future__ import annotations

import os
import sys

import torch

from mapper_tpu_torch.probe_i16.probes import NUMPY_CHECKS, STAGES, plain, probe_input, run


def run_stage(stage: str, device: torch.device) -> bool:
    """Runs every body of `stage` and prints one line each; True if all agreed."""
    x = probe_input(device)
    ok = True
    for body in STAGES[stage]:
        try:
            got = run(stage, body, x)
            wants = []
            if device.type == "cuda":
                wants.append(("plain", plain(stage, body, x)))
            check = NUMPY_CHECKS.get((stage, body))
            if check is not None:
                wants.append(("numpy", torch.from_numpy(check(x.cpu().numpy())).to(device)))
        except Exception as e:  # the diagnostic's boundary: report the body, go on
            print(f"{body}: FAIL {type(e).__name__}: {str(e)[:200]}", flush=True)
            ok = False
            continue
        bad = [name for name, want in wants if not torch.equal(got, want)]
        if bad:
            print(f"{body}: MISMATCH against {', '.join(bad)}: {got[0, :4].tolist()}", flush=True)
            ok = False
        else:
            print(f"{body}: OK{' exact' if wants else ''}", flush=True)
    return ok


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or argv[0] not in STAGES:
        print(f"usage: python -m mapper_tpu_torch.probe_i16 [{'|'.join(STAGES)}]", file=sys.stderr)
        return 2
    device = torch.device(os.environ.get("MAPPER_TPU_TORCH_DEVICE", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"MAPPER_TPU_TORCH_DEVICE={device}: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else device}", flush=True)
    ok = run_stage(argv[0], device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
