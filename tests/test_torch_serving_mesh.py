"""PyTorch port, the HTTP inference service on a mesh of processes, on the
CPU: ``InferenceService`` over ``FCN8s(mesh=...)`` in gloo groups of CPU
processes, against the JAX package's ``InferenceService`` on its 8-device
virtual CPU mesh, on one JAX tree carried across with ``bridge.to_port``.

Rank 0 serves HTTP on port 0 (with the micro-batcher on the first
service), every other rank runs ``InferenceService.follow()``; each rank
counts its ``predict`` calls. The groups are ``test_torch_mesh.py``'s
(gloo, a ``file://`` store, a timeout on init, on each collective and on
the join; the workers import no JAX), run with this file's jobs: one group
of 2 processes for the (2, 1) data-parallel and (1, 2) tensor-parallel
meshes and the serving CLI, one of 4 for (2, 2) with tensor parallelism.
The narrow fp32 model of ``tests/test_torch_serving.py`` (3 classes,
``width_mult=1/32``, ``fc_channels=32``), its decoder redrawn at unit
fan-in scale so that pixels have clear top-2 margins. Tolerances, with
their reasons:

* ids: ``test_torch_mesh.assert_ids_agree``, equal wherever JAX's top-2
  probability margin exceeds 1e-4 and on at least 99.9% of pixels
  (XLA:CPU and oneDNN sum the convolutions in other orders);
* overlays: within 1 LSB wherever the ids agree (the composite is computed
  in fp32 on each side and rounded);
* int8 on a tensor-parallel mesh: against the port's single-rank int8
  service under the same margin rule (the JAX package's quantized predict
  fails its own sharding check there);
* the serving CLI on a group of 2: equal to the single-process model's
  answer (each rank of the (2, 1) mesh runs its rows as one process does).

Run as a script, this file is a gloo rank of ``test_torch_mesh.launch``.
"""

import io
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

from fcn8s_tensorflow_tpu_torch import bridge  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine import serving  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.model import FCN8s  # noqa: E402
from fcn8s_tensorflow_tpu_torch.engine.serving import InferenceService, make_server  # noqa: E402
from fcn8s_tensorflow_tpu_torch.models.fcn8s import init_fcn8s  # noqa: E402
from tests.test_torch_mesh import assert_ids_agree, launch  # noqa: E402

C = 3
NARROW = dict(width_mult=1 / 32, fc_channels=32)
CMAP = {0: (255, 0, 0, 127), 1: (0, 255, 0, 127), 2: (0, 0, 255, 127)}
TILE = (32, 32)
CONCURRENT = 8
WINDOW_MS = 200
MESHES = [(2, 1), (1, 2), (2, 2)]
HTTP_TIMEOUT_S = 120


def _png(image: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return buf.getvalue()


def _images() -> dict:
    """The request images, made from a seed (every process makes the same)."""
    rng = np.random.default_rng(18)

    def image(h, w):
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)

    return {"ids": image(32, 64), "overlay": image(32, 64), "odd": image(30, 50),
            "tiled": image(64, 96), "batch": [image(32, 64) for _ in range(CONCURRENT)]}


# ---------------------------------------------------------------------------
# the workers: one process per mesh position, no JAX
# ---------------------------------------------------------------------------


def _post(base: str, route: str, body: bytes):
    req = urllib.request.Request(base + route, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
            return r.status, np.asarray(Image.open(io.BytesIO(r.read())))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base: str, route: str) -> dict:
    with urllib.request.urlopen(base + route, timeout=HTTP_TIMEOUT_S) as r:
        return json.loads(r.read())


def _requests(name: str, base: str) -> dict:
    """Rank 0: the requests of the service ``name`` through HTTP."""
    im = _images()
    out = {}
    if name == "main":
        out["ids"] = _post(base, "/predict", _png(im["ids"]))
        out["overlay"] = _post(base, "/overlay", _png(im["overlay"]))
        out["overlay_ids"] = _post(base, "/predict", _png(im["overlay"]))
        out["odd"] = _post(base, "/predict", _png(im["odd"]))
        got = [None] * CONCURRENT

        def worker(i):
            got[i] = _post(base, "/predict", _png(im["batch"][i]))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(CONCURRENT)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=HTTP_TIMEOUT_S)
        out["batch"] = got
        out["garbage"] = _post(base, "/predict", b"this is not an image")
    elif name == "faults":
        out["overlay"] = _post(base, "/overlay", _png(im["ids"]))  # no color map
        out["tile"] = _post(base, "/predict", _png(im["ids"]))  # a tile predict refuses
    elif name == "tiled":
        out["ids"] = _post(base, "/predict", _png(im["tiled"]))
        out["overlay"] = _post(base, "/overlay", _png(im["tiled"]))
    elif name == "int8":
        out["ids"] = _post(base, "/predict", _png(im["ids"]))
    out["healthz"] = _get(base, "/healthz")
    out["stats"] = _get(base, "/stats")
    return out


SERVICES = {"main": dict(color_map=CMAP, batch_window_ms=WINDOW_MS, max_batch=8),
            "faults": dict(color_map=None, tile=(48, 48)),
            "tiled": dict(color_map=CMAP, tile=TILE),
            "int8": dict(color_map=CMAP, quantized=True)}


def _services(tp: bool) -> list:
    return ["main", "faults", "tiled"] + (["int8"] if tp else [])


def _job_serve(job, mesh, tree):
    """Each service of ``_services`` in turn on the mesh: rank 0 serves its
    requests over HTTP and closes it, the others follow until then. Every
    rank counts its predict calls per service, and reports the collectives
    its predict captures cut at."""
    tp = job["tp"]
    model = FCN8s.from_params(tree, mesh=mesh, tensor_parallel=tp, device="cpu",
                              compute_dtype=torch.float32, **NARROW)
    calls = [0]
    predict = model.predict

    def counted(*args, **kwargs):
        calls[0] += 1
        return predict(*args, **kwargs)

    model.predict = counted
    out = {"calls": {}}
    for name in _services(tp):
        before = calls[0]
        service = InferenceService(model, **SERVICES[name])
        if service.is_controller:
            srv = make_server(service, port=0)
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            try:
                out[name] = _requests(name, "http://127.0.0.1:%d" % srv.server_address[1])
                out[name]["dispatches"] = service.dispatches
            finally:
                srv.shutdown()
                srv.server_close()
                service.close()
                thread.join(timeout=HTTP_TIMEOUT_S)
            with pytest.raises(RuntimeError, match="follow"):
                service.follow()
        else:
            service.follow()
            with pytest.raises(RuntimeError, match="follows rank 0"):
                service._predict_batch(_images()["ids"][None], False)
        out["calls"][name] = calls[0] - before
    out["captures"] = model.capture_counts()
    out["issued"] = [[call[:4] for call in entry.captured.issued]
                     for step in model._predict_steps._steps.values()
                     for entry in step.captures.values()]
    model.close()
    return out


def _job_cli(job, mesh, tree):
    """``serving.main`` in the group: rank 0 builds the server unstarted
    (``serve=False``), answers /healthz and /predict, and closes it; the
    other rank's ``main`` follows and returns."""
    argv = [job["ckpt"], "0", "--device", "cpu", "--batch-window-ms", "5"]
    server = serving.main(argv, serve=False)
    if isinstance(server, int):  # the follower's exit status
        return {"returned": server}
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        out = {"healthz": _get(base, "/healthz"),
               "ids": _post(base, "/predict", _png(_images()["ids"])),
               "mesh": dict(server.service.model.mesh.shape)}
    finally:
        server.shutdown()
        server.server_close()
        server.service.close()
        thread.join(timeout=HTTP_TIMEOUT_S)
    return out


def _job_orphan(job, mesh, tree):
    """Rank 0 serves with a 0.2 s heartbeat, stays idle for 1 s, answers one
    request and exits without ``close()``; the follower counts the commands
    it received, and its ``follow()`` must raise once rank 0 is gone."""
    InferenceService.HEARTBEAT_S = 0.2
    model = FCN8s.from_params(tree, mesh=mesh, device="cpu", compute_dtype=torch.float32,
                              **NARROW)
    service = InferenceService(model)
    if service.is_controller:
        threading.Event().wait(1.0)
        png = service.predict_png(_png(_images()["ids"]))
        return {"ids": np.asarray(Image.open(io.BytesIO(png)))}
    seen = []
    receive = service._receive

    def counted():
        command = receive()
        seen.append(command[0])
        return command

    service._receive = counted
    try:
        service.follow()
        raised = None
    except Exception as exc:  # noqa: BLE001 — the result under test
        raised = type(exc).__name__
    return {"seen": seen, "raised": raised}


# ---------------------------------------------------------------------------
# the groups and JAX's side
# ---------------------------------------------------------------------------


def _serving_tree() -> dict:
    """A JAX-layout numpy tree of the narrow model (the port's seeded init
    through ``bridge.to_numpy``; JAX's own init runs op by op here, ~17 s),
    its decoder redrawn at unit fan-in scale."""
    tree = bridge.to_numpy(bridge.to_port(init_fcn8s(torch.Generator().manual_seed(18), C,
                                                     **NARROW)))
    rng = np.random.default_rng(18)
    for layer in tree["decoder"].values():
        k = layer["kernel"]
        layer["kernel"] = (rng.normal(size=k.shape) / np.sqrt(np.prod(k.shape[:-1]))).astype(
            np.float32)
        layer["bias"] = (rng.normal(size=layer["bias"].shape) * 0.1).astype(np.float32)
    return tree


def _decode(body: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(body)))


def _jax_side(tree) -> dict:
    """The JAX service on its 8-device mesh, answering the same bodies, and
    JAX's probabilities for the margin rule."""
    import jax
    import jax.numpy as jnp
    from fcn8s_tensorflow_tpu.engine.model import FCN8s as JFCN8s
    from fcn8s_tensorflow_tpu.engine.serving import InferenceService as JService

    jm = JFCN8s(num_classes=C, compute_dtype=jnp.float32, **NARROW)
    assert jm.mesh.shape["data"] == 8
    jm.state = jm.state._replace(params=jax.tree.map(jnp.asarray, tree))
    im = _images()
    main = JService(jm, color_map=CMAP)
    tiled = JService(jm, color_map=CMAP, tile=TILE)
    out = {"health": main.health(), "stats_keys": sorted(main.stats())}
    for key in ("ids", "odd"):
        out[key] = _decode(main.predict_png(_png(im[key])))
        out[f"{key}_probs"] = jm.predict(im[key][None], argmax=False)[0]
    out["overlay"] = _decode(main.predict_png(_png(im["overlay"]), overlay=True))
    out["overlay_ids"] = _decode(main.predict_png(_png(im["overlay"])))
    out["overlay_probs"] = jm.predict(im["overlay"][None], argmax=False)[0]
    out["batch"] = [_decode(main.predict_png(_png(x))) for x in im["batch"]]
    out["batch_probs"] = jm.predict(np.stack(im["batch"]), argmax=False)
    out["tiled"] = _decode(tiled.predict_png(_png(im["tiled"])))
    out["tiled_overlay"] = _decode(tiled.predict_png(_png(im["tiled"]), overlay=True))
    out["tiled_probs"] = jm.predict(im["tiled"][None], argmax=False, tile=TILE)[0]
    jm.close()
    return out


def _single_int8(tree) -> dict:
    """The port's single-rank int8 service on the same tree."""
    model = FCN8s.from_params(tree, device="cpu", compute_dtype=torch.float32, **NARROW)
    image = _images()["ids"]
    out = {"ids": _decode(InferenceService(model, quantized=True).predict_png(_png(image))),
           "probs": model.predict(image[None], argmax=False, quantized=True)[0]}
    model.close()
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every rank's results per mesh (and the CLI's), JAX's answers and the
    port's single-rank int8 answer. The two groups run in threads while
    this process computes JAX's side."""
    tree = _serving_tree()
    root = tmp_path_factory.mktemp("serving_mesh")
    single = FCN8s.from_params(tree, device="cpu", compute_dtype=torch.float32, **NARROW)
    ckpt = single.save(str(root / "ckpt"), force_save=True)
    single.close()
    script = os.path.abspath(__file__)
    groups = {2: {f"{d}x{m}": dict(kind="serve", mesh=(d, m), tp=m > 1)
                  for d, m in MESHES if d * m == 2},
              4: {"2x2": dict(kind="serve", mesh=(2, 2), tp=True)}}
    groups[2]["cli"] = dict(kind="cli", mesh=(2, 1), ckpt=ckpt)
    groups["orphan"] = {"orphan": dict(kind="orphan", mesh=(2, 1))}
    ranks, errors = {}, []

    def run(group):
        try:
            ranks[group] = launch(root / f"world{group}", 2 if group == "orphan" else group,
                                  groups[group], tree=tree, script=script)
        except BaseException as exc:  # noqa: BLE001 — raised again in the fixture
            errors.append(exc)

    for group in groups:
        os.makedirs(root / f"world{group}")
    threads = [threading.Thread(target=run, args=(group,)) for group in groups]
    for t in threads:
        t.start()
    try:
        jax_out = _jax_side(tree)
        int8 = _single_int8(tree)
        cli_single = FCN8s(model_load_dir=ckpt, device="cpu")
        cli_ids = cli_single.predict(_images()["ids"][None])[0]
        cli_single.close()
    finally:
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    by_mesh = {f"{d}x{m}": [r[f"{d}x{m}"] for r in ranks[d * m]] for d, m in MESHES}
    return {"mesh": by_mesh, "cli": [r["cli"] for r in ranks[2]],
            "orphan": [r["orphan"] for r in ranks["orphan"]], "jax": jax_out,
            "int8": int8, "cli_ids": cli_ids}


def _rank0(served, shape):
    return served["mesh"][f"{shape[0]}x{shape[1]}"][0]


def _ok(answer):
    status, body = answer
    assert status == 200, body
    return body


IDS = pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])


@IDS
@pytest.mark.parametrize("key", ["ids", "odd"])
def test_mesh_service_predict_matches_jax(served, shape, key):
    """/predict on a 32x64 image and on an odd 30x50 one (padded to stride
    32 and cropped back): JAX's service's ids by the margin rule."""
    got, want = _ok(_rank0(served, shape)["main"][key]), served["jax"][key]
    assert got.shape == want.shape and got.dtype == np.uint8
    assert_ids_agree(got, want, served["jax"][f"{key}_probs"])


def _assert_overlay_close(got, want, got_ids, want_ids):
    assert got.shape == want.shape and got.dtype == np.uint8
    same = got_ids == want_ids
    assert same.mean() >= 0.999
    diff = np.abs(got.astype(np.int16) - want)
    assert int(diff[same].max()) <= 1


@IDS
def test_mesh_service_overlay_matches_jax(served, shape):
    """/overlay: JAX's composite within 1 LSB where the ids of both
    services' /predict on the same image agree (by the margin rule)."""
    rank0, jx = _rank0(served, shape), served["jax"]
    ids = _ok(rank0["main"]["overlay_ids"])
    assert_ids_agree(ids, jx["overlay_ids"], jx["overlay_probs"])
    _assert_overlay_close(_ok(rank0["main"]["overlay"]), jx["overlay"], ids, jx["overlay_ids"])


@IDS
def test_mesh_service_tiled_matches_jax(served, shape):
    """``tile=(32, 32)`` on a 64x96 image: ids by the margin rule against
    JAX's tiled service, and its overlay where the ids agree."""
    rank0, jx = _rank0(served, shape), served["jax"]
    ids = _ok(rank0["tiled"]["ids"])
    assert_ids_agree(ids, jx["tiled"], jx["tiled_probs"])
    _assert_overlay_close(_ok(rank0["tiled"]["overlay"]), jx["tiled_overlay"], ids,
                          jx["tiled"])


@IDS
def test_mesh_service_microbatches_concurrent_requests(served, shape):
    """8 concurrent /predict requests under a 200 ms window: fewer
    dispatches than requests (each padded to ``max_batch``), each answer
    JAX's by the margin rule."""
    rank0, jx = _rank0(served, shape), served["jax"]
    for i, answer in enumerate(rank0["main"]["batch"]):
        assert_ids_agree(_ok(answer), jx["batch"][i], jx["batch_probs"][i])
    stats = rank0["main"]["stats"]
    assert stats["requests"] == 4 + CONCURRENT and stats["dispatches"] < stats["requests"]


@IDS
def test_mesh_service_maps_errors_before_any_command(served, shape):
    """An undecodable body is 400; overlay without a color map and a tile
    that ``predict`` refuses are 500; none of them reaches a follower (the
    faults service made no predict call on any rank)."""
    ranks = served["mesh"][f"{shape[0]}x{shape[1]}"]
    rank0 = ranks[0]
    code, body = rank0["main"]["garbage"]
    assert code == 400 and "undecodable" in body["error"]
    code, body = rank0["faults"]["overlay"]
    assert code == 500 and "color_map" in body["error"]
    code, body = rank0["faults"]["tile"]
    assert code == 500 and "multiples of 32" in body["error"]
    assert rank0["faults"]["stats"]["errors"] == 2
    assert all(r["calls"]["faults"] == 0 for r in ranks)


@IDS
def test_followers_make_rank0s_calls_and_return_on_close(served, shape):
    """Every follower made exactly rank 0's predict calls per service
    (rank 0's ``dispatches``) and returned at its ``close()``; /healthz and
    /stats keep the JAX service's keys."""
    ranks = served["mesh"][f"{shape[0]}x{shape[1]}"]
    rank0 = ranks[0]
    for name, calls in rank0["calls"].items():
        assert calls == rank0[name]["dispatches"], name
        assert all(r["calls"][name] == calls for r in ranks[1:]), name
    assert rank0["main"]["dispatches"] > 0
    jx = served["jax"]
    assert sorted(rank0["main"]["stats"]) == jx["stats_keys"]
    health = rank0["main"]["healthz"]
    assert sorted(health) == sorted(jx["health"]) and health["status"] == "ok"
    assert health["model_config"]["num_classes"] == C
    assert rank0["tiled"]["healthz"]["tile"] == list(TILE)


@IDS
def test_dispatcher_thread_captures_cut_like_the_followers(served, shape):
    """Rank 0's predict captures, taken on the micro-batcher's dispatcher
    thread and on the request threads, cut at the collectives (kind, op,
    shape, dtype) of each follower's, taken on its main thread; one
    capture per batch shape and head (the int8 tree is replicated, so
    dynamic int8 on a 'model'-only mesh cuts nowhere)."""
    ranks = served["mesh"][f"{shape[0]}x{shape[1]}"]
    issued = ranks[0]["issued"]
    assert issued and any(plan for plan in issued)
    assert all(r["issued"] == issued for r in ranks[1:])
    assert all(r["captures"] == ranks[0]["captures"] for r in ranks[1:])


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_mesh_int8_service_matches_the_single_rank_int8_service(served, shape):
    """``quantized=True`` on a tensor-parallel mesh: the port's single-rank
    int8 service's ids by the margin rule on its int8 probabilities."""
    got = _ok(_rank0(served, shape)["int8"]["ids"])
    assert _rank0(served, shape)["int8"]["healthz"]["quantized"] is True
    assert_ids_agree(got, served["int8"]["ids"], served["int8"]["probs"])


def test_serving_cli_serves_from_rank0_and_the_other_rank_follows(served):
    """``serving.main`` in a gloo group of 2: the checkpoint's model on the
    (2, 1) mesh of both ranks, rank 0's server answers /healthz and
    /predict (the single-process model's ids), and the other rank's
    ``main`` returned 0 after rank 0 closed the service."""
    rank0, rank1 = served["cli"]
    assert rank1 == {"returned": 0, "coords": {"data": 1, "model": 0}}
    assert rank0["mesh"] == {"data": 2, "model": 1}
    assert rank0["healthz"]["status"] == "ok"
    np.testing.assert_array_equal(_ok(rank0["ids"]), served["cli_ids"])


def test_an_idle_rank0_beats_and_a_lost_rank0_ends_its_follower(served):
    """Rank 0 idle for 1 s at a 0.2 s heartbeat sends idle commands, then
    its one predict; when it exits without ``close()`` the follower's
    ``follow()`` raises instead of waiting on, and rank 0's answer is the
    (2, 1) mesh service's."""
    rank0, rank1 = served["orphan"]
    idle, predict = serving._IDLE, serving._PREDICT
    assert rank1["seen"].count(idle) >= 2 and rank1["seen"].count(predict) == 1
    assert rank1["seen"].index(predict) > rank1["seen"].index(idle)
    assert rank1["raised"] is not None
    np.testing.assert_array_equal(rank0["ids"], _ok(_rank0(served, (2, 1))["main"]["ids"]))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tests.test_torch_mesh import _rank_main

    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
               jobs={"serve": _job_serve, "cli": _job_cli, "orphan": _job_orphan})
