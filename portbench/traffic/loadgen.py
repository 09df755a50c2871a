"""The open-loop HTTP load generator, a process of its own so that its work
shares no interpreter lock with the server.

The parent drives it through ``LoadGen`` over the child's standard input
and output, one JSON object a line:

1. the pool: ``{"seed", "pool", "hw"}``; the child makes the pool's scenes
   (``scenes.SERVE_STREAM``) and encodes each as PNG, then answers
   ``{"ready": ...}``;
2. ``{"warm": n, "port": p, "concurrency": c}``: n requests in waves of c,
   answered with ``{"warmed": ..., "errors": ...}``;
3. ``{"go": {"arrivals", "picks", "keep", "grace_s"}}``: request ``i``
   (the body of pool scene ``picks[i]``) is due ``arrivals[i]`` seconds
   after the start and is sent then, whatever is still open; each is timed
   from when it was due until its response body has been read. The answer,
   once every request has its response or ``grace_s`` after the last was
   due, is ``{"records": [[due_s, late_s, latency_s or null, status]],
   "bodies": {i: base64 PNG}}`` with the bodies of the requests in
   ``keep``;
4. ``{"stop": true}`` ends the child.

Run as ``python3 -m portbench.traffic.loadgen``; it imports no torch.
"""

from __future__ import annotations

import asyncio
import base64
import io
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HOST = "127.0.0.1"


def _png(image) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return buf.getvalue()


def encode_pool(seed: int, pool: int, hw) -> list[bytes]:
    from . import scenes

    def one(k):
        images, _ = scenes.batch(seed, scenes.SERVE_STREAM, k, 1, hw[0], hw[1])
        return _png(images[0])

    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as ex:
        return list(ex.map(one, range(pool)))


async def _post(port: int, body: bytes, path: str = "/predict") -> tuple[int, bytes]:
    reader, writer = await asyncio.open_connection(HOST, port)
    try:
        writer.write(f"POST {path} HTTP/1.1\r\nHost: {HOST}\r\nContent-Type: image/png\r\n"
                     f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode() + body)
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        length = None
        while True:
            header = await reader.readline()
            if header in (b"\r\n", b"\n", b""):
                break
            key, _, value = header.decode("latin-1").partition(":")
            if key.strip().lower() == "content-length":
                length = int(value.strip())
        payload = await (reader.readexactly(length) if length is not None else reader.read())
        return status, payload
    finally:
        writer.close()


async def _warm(port: int, bodies: list, n: int, concurrency: int) -> int:
    errors = 0
    for start in range(0, n, concurrency):
        wave = [_post(port, bodies[(start + i) % len(bodies)])
                for i in range(min(concurrency, n - start))]
        for result in await asyncio.gather(*wave, return_exceptions=True):
            errors += isinstance(result, BaseException) or result[0] != 200
    return errors


async def _schedule(port: int, bodies: list, go: dict) -> dict:
    arrivals, picks, keep = go["arrivals"], go["picks"], set(go["keep"])
    records = [[a, None, None, 0] for a in arrivals]
    kept: dict = {}
    clock = time.perf_counter
    t0 = clock() + 0.05

    async def one(i: int, due: float):
        records[i][1] = clock() - due
        try:
            status, payload = await _post(port, bodies[picks[i]])
        except (OSError, ValueError, IndexError, asyncio.IncompleteReadError):
            records[i][3] = -1
            return
        records[i][2], records[i][3] = clock() - due, status
        if i in keep and status == 200:
            kept[str(i)] = base64.b64encode(payload).decode()

    tasks = []
    for i, a in enumerate(arrivals):
        delay = t0 + a - clock()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.create_task(one(i, t0 + a)))
    limit = t0 + (arrivals[-1] if arrivals else 0.0) + go["grace_s"] - clock()
    done, pending = await asyncio.wait(tasks, timeout=max(limit, 0.0))
    for task in pending:
        task.cancel()
    await asyncio.gather(*pending, return_exceptions=True)
    given_up = clock()
    for rec in records:
        if rec[2] is None:  # never answered: it waited until the generator gave up
            rec[2] = given_up - (t0 + rec[0])
            rec[3] = rec[3] or -2
    return {"records": records, "bodies": kept}


def _say(obj) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def main() -> int:
    spec = json.loads(sys.stdin.readline())
    bodies = encode_pool(spec["seed"], spec["pool"], spec["hw"])
    _say({"ready": True, "bytes": sum(map(len, bodies))})
    port = None
    for raw in sys.stdin:
        cmd = json.loads(raw)
        if "warm" in cmd:
            port = cmd["port"]
            errors = asyncio.run(_warm(port, bodies, cmd["warm"], cmd["concurrency"]))
            _say({"warmed": cmd["warm"], "errors": errors})
        elif "go" in cmd:
            _say(asyncio.run(_schedule(port, bodies, cmd["go"])))
        elif cmd.get("stop"):
            break
    return 0


class LoadGen:
    """The parent's side: start the child (it encodes the pool while the
    parent sets up), then warm, go and stop."""

    def __init__(self, seed: int, pool: int, hw, cwd):
        self.proc = subprocess.Popen([sys.executable, "-m", "portbench.traffic.loadgen"],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                                     cwd=str(cwd))
        self._send({"seed": int(seed), "pool": int(pool), "hw": list(hw)})
        self._ready = None

    def _send(self, obj) -> None:
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def _answer(self) -> dict:
        raw = self.proc.stdout.readline()
        if not raw:
            raise RuntimeError(f"the load generator ended (exit code {self.proc.wait()})")
        return json.loads(raw)

    def ready(self) -> dict:
        if self._ready is None:
            self._ready = self._answer()
        return self._ready

    def warm(self, port: int, n: int, concurrency: int) -> dict:
        self.ready()
        self._send({"warm": n, "port": port, "concurrency": concurrency})
        return self._answer()

    def go(self, arrivals, picks, keep, grace_s: float) -> dict:
        self._send({"go": {"arrivals": list(map(float, arrivals)),
                           "picks": list(map(int, picks)), "keep": list(map(int, keep)),
                           "grace_s": float(grace_s)}})
        return self._answer()

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self._send({"stop": True})
                self.proc.stdin.close()
            except (BrokenPipeError, OSError):
                pass
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


if __name__ == "__main__":
    sys.exit(main())
