#!/usr/bin/env python3
"""Count the SASS instructions of a CUDA kernel of mst_torch, by opcode.

    python tools/sass_opcodes.py grid_tail --function grid_tail_kernelILi0E \\
        --span "BAR.SYNC.DEFER_BLOCKING 0x1" MUFU.EX2

Builds ``mst_torch/csrc/<name>.cu`` as the port builds it
(``mst_torch.ops.cuda_build``), disassembles the library with
``cuobjdump -sass`` and prints, for each function whose mangled name
contains ``--function``, its instruction count by opcode. Each ``--span
START STOP`` also counts the instructions from the first one that contains
START to the first one after it that contains STOP (STOP excluded): for
K2's FULL instance, the span above is the consumers' 30-term loop, and
``--span MUFU.EX2 "BAR.SYNC.DEFER_BLOCKING 0x1"`` its epilogue. Needs the
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

INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def functions(sass: str):
    """{mangled name: [instruction text, ...]} of a cuobjdump listing."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name is not None:
            m = INSTRUCTION.match(line)
            if m:
                out[name].append(m.group(1))
    return out


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
    args = ap.parse_args()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    cuda_build.build_all([args.name])
    sass = subprocess.run([tool, "-sass", cuda_build.library_path(args.name)],
                          capture_output=True, text=True, check=True).stdout
    for name, body in functions(sass).items():
        if args.function not in name:
            continue
        print(name)
        show("function", count(body))
        for start, stop in args.span:
            show(f"from {start!r} to {stop!r}",
                 count(span(body, start, stop)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
