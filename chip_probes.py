#!/usr/bin/env python3
"""K3 and K4 of one checkout timed on the card as ``chip_smoke.py``'s
``[probes]`` times them, to set two checkouts' probes side by side.

    python3 chip_probes.py [--root DIR] [--seed 7] [--ncu]

Imports the port from the checkout at ``--root`` (default: this one), draws
``[probes]``' inputs (``chip_smoke.probe_inputs``), holds each probe's output
on the card against its plain version on the CPU, and times it with this
checkout's timers: the launch alone (``chip_smoke.kernel_ms``: 10 launches
queued behind a spin of the card, median of 5) and the wrapper's call with
its input checks (``chip_smoke.median_ms``, median of 5). A checkout whose
wrappers have no ``launch`` (from before the probes' redesign) is launched
as its ``run`` launched, without the checks. Prints the card's name and
power limit, then one JSON line.

``--ncu`` then runs ``ncu --version`` and Nsight Compute's WarpStateStats
section (the warps' stall reasons) over one K4 launch of the same checkout,
and prints each command's exit code and output. To compare two checkouts,
unpack one with ``git archive`` into an ignored directory and run the script
once for each, in turns (parent, change, change, parent).
"""

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

NCU_TIMEOUT_S = 300


def launchers(probes):
    """(K3, K4): the checkout's launch of each probe alone, without the
    wrapper's checks."""
    if hasattr(probes.ProbeGather, "launch"):
        return probes.ProbeGather.launch, probes.ProbeDecodeStep.launch
    lib = probes.load_library()

    def gather(win, idx, steps=probes.STEPS):
        B, W = win.shape
        out = torch.empty((B, 1), dtype=torch.int32, device=win.device)
        code = lib.probe_gather_launch(win.data_ptr(), idx.data_ptr(), B, W, steps,
                                       out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        probes.check_launch(lib, code, "gather probe")
        return out

    def decode_step(buf, p, steps=probes.STEPS):
        capp, B = buf.shape
        emit, scratch, syms = (torch.empty(shape, dtype=torch.int32, device=buf.device)
                               for shape in ((steps, B), (capp, B), (steps, B)))
        code = lib.probe_decode_step_launch(buf.data_ptr(), p.data_ptr(), capp, B, steps,
                                            scratch.data_ptr(), syms.data_ptr(),
                                            emit.data_ptr(),
                                            torch.cuda.current_stream().cuda_stream)
        probes.check_launch(lib, code, "decode-step probe")
        return emit

    return gather, decode_step


def run_ncu(root: Path, seed: int) -> None:
    """``ncu --version``, then the WarpStateStats section over one K4
    launch; each command's exit code and the end of its output."""
    ncu = shutil.which("ncu") or "/usr/local/cuda/bin/ncu"
    for cmd in ([ncu, "--version"],
                [ncu, "--section", "WarpStateStats", "--kernel-name",
                 "regex:probe_decode_step_kernel", "--launch-count", "1", sys.executable,
                 str(Path(__file__).resolve()), "--root", str(root), "--seed", str(seed),
                 "--once"]):
        try:
            done = subprocess.run(cmd, capture_output=True, text=True, timeout=NCU_TIMEOUT_S)
            code, out = done.returncode, done.stdout + done.stderr
        except (OSError, subprocess.TimeoutExpired) as e:
            code, out = None, f"{type(e).__name__}: {e}"
        print(f"[ncu] {' '.join(cmd)}\n[ncu] exit code {code}\n{out[-6000:]}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent))
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--ncu", action="store_true")
    parser.add_argument("--once", action="store_true",
                        help="launch K4 once and exit (the process that --ncu profiles)")
    args = parser.parse_args()
    name = cs.phase_device()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from vector_db_id_compression_tpu_torch.ops import probes

    if not Path(probes.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {probes.__file__}, not the checkout at {root}")
    cuda = torch.device("cuda")
    (win, idx), (buf, p) = cs.probe_inputs(args.seed)
    gather, decode_step = launchers(probes)
    if args.once:
        decode_step(buf.to(cuda), p.to(cuda))
        torch.cuda.synchronize()
        return
    found = {}
    for label, launch, cls, plain, cpu_args in (
            ("probe_gather", gather, probes.ProbeGather, probes.probe_gather_plain, (win, idx)),
            ("probe_decode_step", decode_step, probes.ProbeDecodeStep,
             probes.probe_decode_step_plain, (buf, p))):
        dev_args = tuple(t.to(cuda) for t in cpu_args)
        if not torch.equal(launch(*dev_args).cpu(), plain(*cpu_args)):
            raise AssertionError(f"{label} at {root} differs from its plain version")
        found[label] = {"launch_ms": cs.kernel_ms(lambda: launch(*dev_args)),
                        "call_ms": cs.median_ms(lambda: cls.run(*dev_args))}
        print(f"[probes] {root.name}: {label} == plain; the launch alone "
              f"{found[label]['launch_ms']:.4f} ms, the wrapper's call "
              f"{found[label]['call_ms']:.4f} ms", flush=True)
    print(json.dumps({"root": str(root), "kind": name, "probes": found}), flush=True)
    if args.ncu:
        run_ncu(root, args.seed)


if __name__ == "__main__":
    main()
