#!/usr/bin/env python3
"""Compare the machine code (SASS) of one kernel source built from two
checkouts, function by function.

    python3 scripts/cuda_sass_diff.py ROOT_A ROOT_B [SOURCE ...]

Needs the CUDA toolkit (``nvcc``, ``cuobjdump``); no GPU.  Builds
``titan_tpu_torch/csrc/<SOURCE>.cu`` (default: adjoint) from each checkout
with that checkout's own ``_build.py`` and flags, disassembles both
libraries with ``cuobjdump -sass`` and prints one line per function of
ROOT_A: IDENTICAL (the same instructions, addresses and encodings left
out), PARAMS-ONLY (every instruction the same but for constant-bank
operands, all of those that differ moved by one shift: an argument
structure that grew at its end moves the kernel parameters after it),
DIFFERS (with both instruction counts) or MISSING in ROOT_B.
Function names are matched after two normalisations: the hash in an
anonymous namespace's mangled name, which changes with the translation
unit, is dropped, and a function that ROOT_B lacks under ROOT_A's name is
looked for with a trailing ``false`` template argument (``<A, REM>``
becoming ``<A, REM, false>``).  It checks nothing and exits 0.
"""

import re
import subprocess
import sys
from pathlib import Path

CUOBJDUMP = Path("/usr/local/cuda/bin/cuobjdump")


def build(root: str, source: str) -> str:
    """The path of ``source``'s library built from checkout ``root``."""
    code = (f"import sys; sys.path.insert(0, {root!r}); "
            "from titan_tpu_torch import _build; "
            f"_build.build({source!r}); "
            f"print(_build.library_path({source!r}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def sass(lib: str) -> dict:
    """{mangled function name: [instruction text]} of a library."""
    tool = str(CUOBJDUMP) if CUOBJDUMP.exists() else "cuobjdump"
    txt = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in txt.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            funcs[cur].append(m.group(1))
    return funcs


def anon(name: str) -> str:
    return re.sub(r"\d+_GLOBAL__N__\w*?_cu_[0-9a-f]+", "ANON", name)


PARAM = re.compile(r"c\[0x0\]\[(0x[0-9a-f]+)\]")


def param_shift(a: list, b: list):
    """The byte shift by which every differing constant-bank operand of
    ``b`` follows ``a``'s, where the two differ in nothing else; else
    None."""
    if len(a) != len(b):
        return None
    shifts = set()
    for x, y in zip(a, b):
        if x == y:
            continue
        if PARAM.sub("c[0x0][P]", x) != PARAM.sub("c[0x0][P]", y):
            return None
        shifts.update(int(oy, 16) - int(ox, 16) for ox, oy in
                      zip(PARAM.findall(x), PARAM.findall(y)) if ox != oy)
    return shifts.pop() if len(shifts) == 1 else None


def widened(name: str) -> str:
    """ROOT_B's name with a trailing ``Lb0E`` template argument removed."""
    return anon(re.sub(r"(Lb[01]E)Lb0EE", r"\1E", name))


def main() -> int:
    root_a, root_b, *sources = sys.argv[1:]
    for source in sources or ["adjoint"]:
        a = sass(build(root_a, source))
        b = sass(build(root_b, source))
        exact = {anon(k): v for k, v in b.items()}
        wide = {widened(k): v for k, v in b.items()}
        print(f"{source}.cu: {root_a} against {root_b}")
        for name, ins in sorted(a.items()):
            other = exact.get(anon(name), wide.get(anon(name)))
            if other is None:
                state = "MISSING"
            elif other == ins:
                state = "IDENTICAL"
            elif param_shift(ins, other) is not None:
                state = (f"PARAMS-ONLY ({len(ins)} instructions; parameter "
                         f"offsets moved by {param_shift(ins, other):+d} B)")
            else:
                state = f"DIFFERS ({len(ins)} vs {len(other)} instructions)"
            print(f"  {state} {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
