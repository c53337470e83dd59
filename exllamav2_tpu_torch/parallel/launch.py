"""Start the ranks of one world on this host and hold them to a deadline.

``launch(argv, nprocs, timeout=...)`` starts ``nprocs`` copies of
``python <argv>`` as ranks 0 .. nprocs - 1 (RANK, LOCAL_RANK, WORLD_SIZE,
and EXL2_INIT_METHOD naming a fresh file store, which
parallel/sharding.init_distributed reads), so several worlds on one host
never contend for a port. It returns each rank's standard output. One rank
that exits non-zero, or the deadline, kills every rank: a rank left waiting
in a collective would otherwise hang until its own timeout. Output goes to
files, not pipes, so a rank that prints much never blocks.

    python -m exllamav2_tpu_torch.parallel.launch -n 2 --timeout 600 -- \\
        -m exllamav2_tpu_torch.cli.tp_worker --device cpu

On several GPUs, ``torchrun --nproc-per-node N`` starts the same programs.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

__all__ = ["launch", "RankFailed"]


class RankFailed(RuntimeError):
    """A rank exited non-zero or the world passed its deadline."""


def launch(argv: list[str], nprocs: int, *, timeout: float,
           env: dict | None = None, cwd: str | None = None) -> list[str]:
    """Run `python argv` as nprocs ranks of one world -> each rank's
    stdout. Raises RankFailed (after killing every rank) when one exits
    non-zero or `timeout` seconds pass."""
    tmp = tempfile.mkdtemp(prefix="exl2_ranks_")
    base = dict(os.environ if env is None else env)
    base.update(WORLD_SIZE=str(nprocs),
                EXL2_INIT_METHOD="file://" + os.path.join(tmp, "store"))
    procs, files = [], []
    try:
        for r in range(nprocs):
            out = open(os.path.join(tmp, f"rank{r}.out"), "w+")
            err = open(os.path.join(tmp, f"rank{r}.err"), "w+")
            files.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, *argv], stdout=out, stderr=err, cwd=cwd,
                env=dict(base, RANK=str(r), LOCAL_RANK=str(r))))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            late = time.monotonic() > deadline
            if bad or late:
                for p in procs:
                    p.kill()
                for p in procs:
                    p.wait()
                r = bad[0] if bad else 0
                err = files[r][1]
                err.seek(0)
                why = (f"rank {r} exited with {codes[r]}" if bad
                       else f"the ranks passed their {timeout:.0f} s "
                            "deadline")
                raise RankFailed(f"{why}:\n{err.read()[-6000:]}")
            if all(c == 0 for c in codes):
                break
            time.sleep(0.1)
        outs = []
        for out, _ in files:
            out.seek(0)
            outs.append(out.read())
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-n", "--nprocs", type=int, required=True)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="after --: the arguments of python")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    for out in launch(cmd, args.nprocs, timeout=args.timeout):
        sys.stdout.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
