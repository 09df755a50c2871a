"""One process per card for a cell on more than one chip.

The command's process is rank 0: it starts ranks 1..N-1 as
``python3 -m portbench.ranks '<spec>'`` (the cell, the run's arguments, the
rank and the group's ``tcp://127.0.0.1:<port>`` address), runs its own part
and prints the result; every rank runs the driver's ``run_rank`` with the
same arguments. The children's output goes to standard error, and rank 0
waits for each of them before it returns. A rank that finds JAX or the JAX
package among its modules once its part is done ends with code 3, so rank
0 raises and prints no result.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

from . import harness

JOIN_S = 600.0


def init_method() -> str:
    """A free localhost port for the group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def spec(ctx: harness.Context, rank: int, init: str) -> dict:
    return {"cell": ctx.cell.name, "seed": ctx.seed, "seconds": ctx.seconds,
            "trace": ctx.trace, "device": ctx.device, "width": ctx.width, "shape": ctx.shape,
            "rank": rank, "init": init}


def spawn(ctx: harness.Context, init: str, code: str | None = None) -> list:
    """Start ranks 1..chips-1; ``code`` (tests) runs in place of this
    module's ``main`` and is given the spec as its first argument."""
    args = ["-c", code] if code else ["-m", "portbench.ranks"]
    return [subprocess.Popen([sys.executable, *args, json.dumps(spec(ctx, r, init))],
                             cwd=str(harness.root()), stdout=sys.stderr.fileno())
            for r in range(1, ctx.cell.chips)]


def join(procs: list) -> None:
    """Wait for every rank; end any that outlives ``JOIN_S``; raise if one
    failed."""
    deadline = time.monotonic() + JOIN_S
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    if any(codes):
        raise RuntimeError(f"ranks 1..{len(procs)} ended with codes {codes}")


def main(argv=None) -> int:
    s = json.loads((argv if argv is not None else sys.argv[1:])[0])
    harness.cache_dirs()
    cell = harness.cell(s["cell"])
    ctx = harness.Context(cell=cell, seed=s["seed"], seconds=s["seconds"], trace=s["trace"],
                          t0=time.perf_counter(), device=s["device"], width=s["width"],
                          shape=s["shape"])
    harness.driver(cell.traffic["kind"]).run_rank(ctx, s["rank"], s["init"])
    found = harness.forbidden_modules()
    if found:
        print(f"portbench rank {s['rank']}: modules of JAX or the JAX package were loaded: "
              f"{', '.join(found)}", file=sys.stderr, flush=True)
        return 3
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    sys.exit(main())
