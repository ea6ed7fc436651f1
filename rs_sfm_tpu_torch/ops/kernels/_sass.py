"""Instructions per loop body in a kernel's SASS, from `cuobjdump -sass`.

    python -m rs_sfm_tpu_torch.ops.kernels._sass LIB.so KERNEL MARKER

prints, for each loop of the kernel functions whose name contains KERNEL
(a backward branch to an earlier address), its instructions, how many of
them are the MARKER opcode, and instructions per marker.  With MARKER an
opcode that runs once per unit of work (MUFU.RCP: one IEEE division per
pixel and hypothesis in csrc/score.cu), the innermost loop's instructions
per marker are its instructions per unit of work.  Needs the CUDA
toolkit's cuobjdump; runs where the library was built.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def _cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/cuobjdump")
    return str(default) if default.exists() else None


def functions(sass: str) -> dict[str, list[tuple[int, str]]]:
    """{function name: [(address, instruction text)]} of cuobjdump -sass
    output."""
    out: dict[str, list[tuple[int, str]]] = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :", 1)[1].strip()
            out[current] = []
            continue
        m = _INSN.search(line)
        if current is not None and m:
            out[current].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def _opcode(text: str) -> str:
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def loops(insns: list[tuple[int, str]], marker: str):
    """[(first address, instructions, markers)] of every backward branch's
    body, innermost (fewest instructions) first."""
    found = []
    for addr, text in insns:
        if not _opcode(text).startswith("BRA"):
            continue
        m = _TARGET.search(text)
        if m is None or int(m.group(1), 16) > addr:
            continue
        start = int(m.group(1), 16)
        body = [t for a, t in insns if start <= a <= addr
                and _opcode(t) != "NOP"]
        found.append((start, len(body),
                      sum(_opcode(t) == marker for t in body)))
    return sorted(found, key=lambda f: f[1])


def _sass(library: str):
    tool = _cuobjdump()
    if tool is None:
        return None
    return subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def opcode_counts(library: str, kernel: str):
    """{function: {full opcode: count}} of the kernel functions named like
    `kernel`, or None without cuobjdump."""
    sass = _sass(library)
    if sass is None:
        return None
    counts = {}
    for name, insns in functions(sass).items():
        if kernel not in name:
            continue
        found: dict[str, int] = {}
        for _, text in insns:
            op = _opcode(text)
            found[op] = found.get(op, 0) + 1
        counts[name] = found
    return counts


def opcodes(library: str, kernel: str, prefix: str) -> list[str]:
    """'function: opcode xN' for each full opcode starting with `prefix`
    (e.g. "RED" or "ATOM") in the kernel functions named like `kernel`."""
    counts = opcode_counts(library, kernel)
    if counts is None:
        return ["cuobjdump not found: SASS not read"]
    lines = []
    for name, found in counts.items():
        ops = sorted((op, c) for op, c in found.items()
                     if op.startswith(prefix))
        lines.append(f"{name}: " + (", ".join(f"{op} x{c}" for op, c in ops)
                                    or f"no {prefix}"))
    return lines or [f"{kernel}: not found in {library}"]


def report(library: str, kernel: str, marker: str) -> list[str]:
    sass = _sass(library)
    if sass is None:
        return ["cuobjdump not found: SASS not counted"]
    lines = []
    for name, insns in functions(sass).items():
        if kernel not in name:
            continue
        for start, n, marks in loops(insns, marker):
            per = f"{n / marks:.1f}" if marks else "-"
            lines.append(f"{name}: loop at 0x{start:04x}: {n} instructions,"
                         f" {marks} {marker}, {per} per {marker}")
    return lines or [f"{kernel}: no loop found in {library}"]


if __name__ == "__main__":
    if len(sys.argv) != 4:
        raise SystemExit(__doc__)
    print("\n".join(report(*sys.argv[1:])))
