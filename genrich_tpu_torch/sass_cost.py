"""Float operations per libm call, counted in the SASS of probe kernels.

    python -m genrich_tpu_torch.sass_cost

Needs nvcc and cuobjdump (the CUDA toolkit), not a card.  Builds one
probe kernel per function that kernels K1-K3 call (``o[i] = f(a[i])``,
or ``a[i] / b[i]`` for an IEEE division) with the port's nvcc flags
(``kernels.NVCC_FLAGS``, sm_90a), and a copy kernel per type as a
baseline; disassembles the cubin with ``cuobjdump -sass``; and counts in
each kernel, from its entry to its first EXIT, the instructions of the
float units, FP32 and FP64 apart, an FMA as two operations (as the
peak rates count it).  What nvcc places after the first EXIT (the
slow paths of a division, the special cases of a function) is left
out: the count is the path an ordinary argument takes, with every
branch before the EXIT counted as taken.  The baseline's counts are
subtracted.  Prints one JSON object ``{function: {"fp32": n, "fp64":
n}}``; ``testing.LIBM_OPS`` holds the figures of a run on an H100.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

from . import kernels

# (probe name, C type, expression of a[i] and b[i])
PROBES = [
    ("copy_f32", "float", "a[i]"),
    ("logf", "float", "logf(a[i])"),
    ("log10f", "float", "log10f(a[i])"),
    ("expf", "float", "expf(a[i])"),
    ("log1pf", "float", "log1pf(a[i])"),
    ("sqrtf", "float", "sqrtf(a[i])"),
    ("fdiv", "float", "a[i] / b[i]"),
    ("copy_f64", "double", "a[i]"),
    ("log", "double", "log(a[i])"),
    ("log1p", "double", "log1p(a[i])"),
    ("expm1", "double", "expm1(a[i])"),
    ("exp", "double", "exp(a[i])"),
    ("lgamma", "double", "lgamma(a[i])"),
    ("ddiv", "double", "a[i] / b[i]"),
]
BASELINE = {"float": "copy_f32", "double": "copy_f64"}

_FLOAT_OPS = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET",
              "FCHK", "FRND", "FADD32I", "FMUL32I", "FFMA32I", "FSWZADD",
              "MUFU", "I2F", "F2I", "F2F", "I2FP", "F2IP", "DADD", "DMUL",
              "DFMA", "DSETP", "DMNMX", "DSET"}
_FMA = {"FFMA", "FFMA32I", "DFMA"}
_INSTR = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                    r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)")


def probe_source() -> str:
    lines = ["#include <math.h>"]
    for name, ty, expr in PROBES:
        lines.append(
            f'extern "C" __global__ void probe_{name}(const {ty}* a, '
            f"const {ty}* b, {ty}* o) {{ int i = threadIdx.x; "
            f"o[i] = {expr}; }}")
    return "\n".join(lines) + "\n"


def count_sass(sass: str):
    """{kernel: {"fp32": ops, "fp64": ops}} from its entry to its first
    EXIT."""
    out, cur, done = {}, None, False
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            out[cur] = {"fp32": 0, "fp64": 0}
            done = False
            continue
        m = _INSTR.match(line)
        if cur is None or done or not m:
            continue
        op, mods = m.group(1), m.group(2)
        if op == "EXIT":
            done = True
            continue
        if op not in _FLOAT_OPS:
            continue
        unit = "fp64" if (op.startswith("D") or "F64" in mods
                          or "64H" in mods) else "fp32"
        out[cur][unit] += 2 if op in _FMA else 1
    return out


def measure():
    nvcc = kernels._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        src = os.path.join(tmp, "probe.cu")
        cubin = os.path.join(tmp, "probe.cubin")
        with open(src, "w") as f:
            f.write(probe_source())
        flags = [f for f in kernels.NVCC_FLAGS
                 if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
        subprocess.run([nvcc] + flags + ["-cubin", "-o", cubin, src],
                       check=True, capture_output=True, text=True)
        sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
    counts = count_sass(sass)
    by_name = {name: counts[f"probe_{name}"] for name, _, _ in PROBES}
    res = {}
    for name, ty, _ in PROBES:
        if name in BASELINE.values():
            continue
        base = by_name[BASELINE[ty]]
        res[name] = {u: by_name[name][u] - base[u] for u in ("fp32", "fp64")}
    return res


def main() -> int:
    print(json.dumps(measure()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
