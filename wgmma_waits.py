"""Which wgmma waits the compiler kept: the SASS of each Hopper wgmma
kernel in the built library (cuobjdump -sass), with the count of each
WARPGROUP.DEPBAR form (`wgmma.wait_group N` compiles to DEPBAR.LE gsb0,
N), of WARPGROUP.ARRIVE (a wgmma.fence), the highest register the kernel
names and its local-memory stores and loads (STL, LDL: spills). A loop
whose waits all read 0x0 has had its products serialised (ptxas warns
C7518 when it does so).

Run from the repository root on a machine with nvcc:

    python3 wgmma_waits.py
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

from grasp_any_region_tpu_torch.ops import _build

KERNELS = ("flash_fwd_sm90_kernel", "vit_fwd_rope_sm90_kernel", "flash_bwd_sm90_kernel",
           "flash_bwd_wide_sm90_kernel", "gemm_sm90_kernel")
WIDE = "flash_bwd_wide_sm90_kernel"


def cuobjdump() -> str:
    return shutil.which("cuobjdump") or str(Path(_build.nvcc_path()).parent / "cuobjdump")


def print_sass(path: Path, kernels=KERNELS) -> None:
    sass = subprocess.run([cuobjdump(), "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    for func, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S):
        if not any(k in func for k in kernels):
            continue
        waits = collections.Counter(re.findall(r"WARPGROUP\.DEPBAR\.LE gsb0, (0x[0-9a-f]+)", body))
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", body)]
        stl, ldl = (len(re.findall(rf"\b{op}\b", body)) for op in ("STL", "LDL"))
        print(f"[sass] {func}: DEPBAR.LE {dict(sorted(waits.items()))}, "
              f"ARRIVE {body.count('WARPGROUP.ARRIVE')}, "
              f"HGMMA {len(re.findall(r'HGMMA', body))}, highest register R{max(regs, default=0)}, "
              f"STL {stl}, LDL {ldl}")


def ptxas_lines(log: str, kernel: str) -> None:
    for m in re.finditer(rf"Compiling entry function '(\S*{kernel}\S*)' for 'sm_90a'\n.*\n(.*)\n(.*)\n",
                         log):
        print(f"[ptxas] {m.group(1)}: {m.group(2).strip()}; {m.group(3).strip()[len('ptxas info    : '):]}")


def main() -> int:
    lib, _ = _build.build()
    log = (lib.parent / "build.log").read_text()
    print(f"[sass] ptxas C7518 (wgmma serialised) warnings in the build: {log.count('C7518')}")
    ptxas_lines(log, WIDE)
    print_sass(lib)
    return 0


if __name__ == "__main__":
    sys.exit(main())
