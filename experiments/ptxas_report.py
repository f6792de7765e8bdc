"""What ptxas reports for every kernel of `mapper_tpu_torch/align/csrc/`:
registers, spills, stack and shared memory, each kernel name demangled.
Compiles each source with the library's own flags plus `-Xptxas -v` into a
temporary directory; loads nothing and needs no card, only nvcc.

    python3 experiments/ptxas_report.py [name filter]

Prints one line per kernel that matches the filter (all by default).
"""
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from mapper_tpu_torch.align import kernels



def report(csrc: Path | None = None, pattern: str = "", names: tuple = ()) -> list[str]:
    """One line per kernel of `csrc` (default: the package's) whose demangled
    name contains `pattern`: registers, spills, stack, shared memory; only
    the sources named in `names`, when given."""
    nvcc = kernels.find_nvcc()
    if nvcc is None:
        sys.exit("nvcc not found")
    filt = shutil.which("cu++filt") or str(Path(nvcc).parent / "cu++filt")
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for src in kernels.sources(csrc):
            if names and src.name not in names:
                continue
            cmd = [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(Path(tmp) / "k.o"), str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                sys.exit(proc.stderr)
            name, found = None, 0
            for line in proc.stderr.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    name = subprocess.run([filt, m.group(1)], capture_output=True, text=True).stdout.strip()
                    stack = ""
                elif name and "bytes stack frame" in line:
                    stack = line.split("ptxas info    :")[-1].strip()
                elif name and "Used" in line and "registers" in line:
                    if pattern in name:
                        lines.append(f"{src.name}: {name}: {line.split('ptxas info    :')[-1].strip()}; {stack}")
                    found += 1
                    name = None
            if not found:  # a format this parser does not know: the raw report
                lines.append(proc.stderr)
    return lines


if __name__ == "__main__":
    print("\n".join(report(pattern=sys.argv[1] if len(sys.argv) > 1 else "")))
