#!/usr/bin/env python3
"""Instructions per inner loop of a port kernel, read from its SASS.

Builds a CUDA source of the PyTorch port with the port's own nvcc flags
(``genrec_tpu_torch/ops/_build.py``), disassembles it with ``cuobjdump
-sass`` and prints, for each kernel whose name matches ``--kernel``, every
loop (a backward branch) that holds tensor-core instructions: its length
and its most frequent opcodes. Run from the root of a checkout, on a machine
with the CUDA toolkit:

    python3 -m genrec_tpu_torch.tools.sass_loops genrec_tpu_torch/csrc/t5_attention_bwd.cu \\
        --kernel 't5_attention_bwd_kernelILi2E'

With ``--nested`` it also prints each loop that holds other loops, counting
only the instructions outside them (a loop over tiles whose inner tile loop
was unrolled, say). The source may be any copy of a kernel file, so two
versions can be held side by side.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys
import tempfile

from genrec_tpu_torch.ops import _build

_LINE = re.compile(r"\s*/\*([0-9a-f]+)\*/\s+(.*?);")
_BRANCH = re.compile(r"BRA\s+.*?0x([0-9a-f]+)")


def sass(source: str) -> str:
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "lib.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, source], check=True,
                       capture_output=True, text=True)
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        return subprocess.run([cuobjdump, "-sass", lib], check=True, capture_output=True,
                              text=True).stdout


def loops(function_text: str, nested: bool = False):
    """(start, end, instructions, opcode counts) of each innermost loop (one
    that holds no other loop) with an HMMA. With ``nested``, every loop with
    an HMMA outside its inner loops, counting only those instructions: the
    loop's own work per trip, its inner loops left out."""
    code = [(int(m.group(1), 16), m.group(2)) for m in map(_LINE.match,
                                                            function_text.split("\n")) if m]
    index = {addr: i for i, (addr, _) in enumerate(code)}
    spans = []
    for addr, ins in code:
        m = _BRANCH.search(ins)
        if m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    for start, end in spans:
        inner = [(s, e) for s, e in spans if start <= s and e <= end and (s, e) != (start, end)]
        if inner and not nested:
            continue
        body = [text for addr, text in code[index.get(start, 0):index[end] + 1]
                if not any(s <= addr <= e for s, e in inner)]
        ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", x).split()[0].split(".")[0]
                                  for x in body)
        if ops["HMMA"]:
            yield start, end, len(body), ops


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source")
    ap.add_argument("--kernel", default="", help="substring of the mangled kernel name")
    ap.add_argument("--nested", action="store_true",
                    help="also loops that hold other loops, counting their own instructions")
    args = ap.parse_args()
    for function in re.split(r"\n\s*Function : ", sass(args.source))[1:]:
        name = function.split("\n")[0].strip()
        if args.kernel not in name:
            continue
        n = sum(1 for line in function.split("\n") if _LINE.match(line))
        print(f"{name}: {n} instructions")
        for start, end, length, ops in loops(function, args.nested):
            top = ", ".join(f"{k} {v}" for k, v in ops.most_common(10))
            print(f"  loop {start:#07x}-{end:#07x}: {length} instructions, HMMA {ops['HMMA']}; "
                  f"{top}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
