#!/usr/bin/env python3
"""Count the SASS instructions of a CUDA kernel of mst_torch, by opcode.

    python tools/sass_opcodes.py grid_tail --function grid_tail_kernelILi0ELb0E \\
        --span "BAR.SYNC.DEFER_BLOCKING 0x1" MUFU.EX2
    python tools/sass_opcodes.py grid_tail_bwd \\
        --function grid_tail_bwd_kernelILi0ELb0E --loops

Builds ``mst_torch/csrc/<name>.cu`` as the port builds it
(``mst_torch.ops.cuda_build``), disassembles the library with
``cuobjdump -sass`` and prints, for each function whose mangled name
contains ``--function``, its instruction count by opcode. Each ``--span
START STOP`` also counts the instructions from the first one that contains
START to the first one after it that contains STOP (STOP excluded): for
K2's FULL instance, the span above is the consumers' 30-term loop, and
``--span MUFU.EX2 "BAR.SYNC.DEFER_BLOCKING 0x1"`` its epilogue of 5
outputs; in the bf16 instance (``Lb1E``) a thread owns two cells, so the
loop has 60 terms and the epilogue 10 outputs. ``--loops``
counts the body of every loop (from a backward branch's target to the
branch), shortest first: for K3's FULL instance, in either form, the loop
that holds the 70 FFMAs is the pass over octaves, two octaves of 7 (o, d)
terms a trip (the shorter ones are barrier waits). Needs the
CUDA toolkit (``nvcc``, ``cuobjdump``): run it on the machine with the card.
"""

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mst_torch.ops import cuda_build  # noqa: E402

INSTRUCTION = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
BRANCH = re.compile(r"\bBRA(?:\.\w+)*\s+`?\(?0x([0-9a-f]+)")


def functions(sass: str):
    """{mangled name: [(address, instruction text), ...]} of a cuobjdump
    listing."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name is not None:
            m = INSTRUCTION.match(line)
            if m:
                out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def loops(instructions):
    """The body of each loop of an [(address, text), ...] listing, from a
    backward branch's target to the branch itself, shortest first (a
    branch to itself, the idle loop after EXIT, is none)."""
    bodies = []
    for address, text in instructions:
        m = BRANCH.search(text)
        if m and int(m.group(1), 16) < address:
            target = int(m.group(1), 16)
            bodies.append([t for a, t in instructions
                           if target <= a <= address])
    return sorted(bodies, key=len)


def opcode(text: str) -> str:
    """The opcode of one instruction, without its predicate and modifiers."""
    text = re.sub(r"^@!?U?P\w+\s+", "", text)
    return text.split()[0].split(".")[0]


def count(instructions):
    return collections.Counter(opcode(t) for t in instructions)


def span(instructions, start: str, stop: str):
    """The instructions from the first containing ``start`` up to the first
    after it containing ``stop``."""
    first = next(i for i, t in enumerate(instructions) if start in t)
    last = next(i for i in range(first + 1, len(instructions))
                if stop in instructions[i])
    return instructions[first:last]


def show(label, counter):
    top = ", ".join(f"{op} {n}" for op, n in counter.most_common())
    print(f"  {label}: {sum(counter.values())} instructions ({top})")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name", choices=sorted(cuda_build.KERNEL_FLAGS))
    ap.add_argument("--function", default="",
                    help="substring of the mangled function names to show")
    ap.add_argument("--span", nargs=2, action="append", default=[],
                    metavar=("START", "STOP"))
    ap.add_argument("--loops", action="store_true",
                    help="count the body of every loop, shortest first")
    args = ap.parse_args()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    cuda_build.build_all([args.name])
    sass = subprocess.run([tool, "-sass", cuda_build.library_path(args.name)],
                          capture_output=True, text=True, check=True).stdout
    for name, listing in functions(sass).items():
        if args.function not in name:
            continue
        body = [text for _, text in listing]
        print(name)
        show("function", count(body))
        for start, stop in args.span:
            show(f"from {start!r} to {stop!r}",
                 count(span(body, start, stop)))
        if args.loops:
            for i, loop in enumerate(loops(listing)):
                show(f"loop {i}", count(loop))
    return 0


if __name__ == "__main__":
    sys.exit(main())
