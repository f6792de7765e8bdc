"""The SASS of a built kernel library, function by function, and the x loops
of a warp kernel: the spans of its backward branches whose body holds a
SHFL.UP (the warp min after the loop uses SHFL.BFLY), innermost first.
Imported by the experiments that print SASS instruction mixes; needs the
CUDA toolkit's cuobjdump beside nvcc.
"""
import collections
import re
import subprocess
from pathlib import Path

from mapper_tpu_torch.align import kernels


def functions(lib_path) -> dict[str, str]:
    """{mangled kernel name: its SASS text} of the shared library or cubin."""
    cuobjdump = Path(kernels.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    return {part.splitlines()[0].strip(): part for part in text.split("Function : ")[1:]}


def _instructions(sass: str) -> list[tuple[int, str, str]]:
    """(address, opcode without modifiers, line) of each instruction."""
    return [(int(a, 16), op.split(".")[0], line) for line in sass.splitlines()
            for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)]


def instruction_mix(sass: str) -> collections.Counter:
    """The opcode counts of one function's SASS."""
    return collections.Counter(op for _, op, _ in _instructions(sass))


def shuffle_loops(sass: str) -> list[tuple[collections.Counter, str]]:
    """(instruction mix, text) of each loop of one function's SASS whose
    body holds a SHFL.UP, innermost (fewest instructions) first."""
    ins = _instructions(sass)
    loops = []
    for addr, op, line in ins:
        target = re.search(r"BRA\s+(?:\S+\s+)?0x([0-9a-f]+)", line) if op == "BRA" else None
        if target and int(target.group(1), 16) < addr:
            body = [(o, l) for a, o, l in ins if int(target.group(1), 16) <= a <= addr]
            if any("SHFL.UP" in l for _, l in body):
                loops.append((collections.Counter(o for o, _ in body), "\n".join(l for _, l in body)))
    return sorted(loops, key=lambda loop: sum(loop[0].values()))


def mix_line(mix: collections.Counter) -> str:
    return f"{sum(mix.values())} instructions; " + ", ".join(f"{op} {k}" for op, k in mix.most_common())
