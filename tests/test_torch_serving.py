"""The port's serving runtime (``gspn_tpu_torch.serve.runtime``): the
counterparts of ``tests/test_serving.py``'s twelve cases on the CPU, plus
the two packages against each other: the JAX ``Client`` against the port's
``Server`` and the port's ``Client`` against a JAX ``Server``, and the
port's exported program against JAX's ``make_inference_fn`` on the frozen
fixture's weights with the same noise fed to both.

The live reference of every session and socket case is the port's own
``make_inference_fn`` with the noise the session draws for that chunk
(``runtime.chunk_noise(seed, ci)``): bitwise equal."""

import dataclasses
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gspn_tpu_torch import convert
from gspn_tpu_torch.data import synthetic
from gspn_tpu_torch.models import pipeline as tpl
from gspn_tpu_torch.models.gspn import GSPN
from gspn_tpu_torch.models.rpointnet import RPointNet
from gspn_tpu_torch.serve import (
    Client,
    InferenceSession,
    Server,
    export_inference,
    load_artifact,
    pipeline_config_from_manifest,
    save_artifact,
    session_from_checkpoints,
)
from gspn_tpu_torch.serve import export as sx
from gspn_tpu_torch.serve import runtime as srt
from gspn_tpu_torch.train.checkpoint import CheckpointManager
from gspn_tpu_torch.train.steps import TrainState, make_optimizer
from tests.test_fixtures import _base_pipeline_variables, _load
from tests.test_pipeline_eval import TINY
from tests.torch_parity import as_numpy_tree, n, pipeline_config, t

B, N = 2, 192
CFG = pipeline_config(dataclasses.replace(TINY, mask_thresh=0.47))
FIELDS = tpl.PREDICTION_FIELDS


def _state(cfg, seed=0):
    return tpl.init_pipeline_variables(cfg, torch.Generator().manual_seed(seed), N)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    model = tpl.PipelineModel(CFG)
    model.load_state_dict(_state(CFG))
    program = export_inference(CFG, model.eval(), N, batch_size=B, device="cpu")
    return save_artifact(tmp_path_factory.mktemp("serve") / "tiny.gspnt", program, CFG)


@pytest.fixture(scope="module")
def session(artifact):
    """A session of the seeded weights, shared (a session serves many
    threads)."""
    return InferenceSession(artifact, _state(CFG), device="cpu")


def _scenes(b, seed=0):
    sb = synthetic.scene_batch(np.random.default_rng(seed), b, n_points=N, max_instances=3,
                               extent=2.0)
    return sb["xyz"], sb["valid"]


def _live(state, xyz, valid, seed, chunk=0, cfg=CFG):
    """The live port on one chunk with the noise a session draws for it."""
    model = tpl.PipelineModel(cfg)
    model.load_state_dict(state)
    eps = srt.chunk_noise(seed, chunk, (xyz.shape[0], cfg.num_seeds, cfg.gspn.latent_dim))
    with torch.inference_mode():
        out = tpl.make_inference_fn(cfg)(model.eval(), t(xyz), t(valid), z_eps=eps)
    return {f: n(getattr(out, f)) for f in FIELDS}


def _equal(got, want, rows=slice(None)):
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f][rows], err_msg=f)


def test_manifest_config_roundtrip(artifact):
    _, manifest = load_artifact(artifact, "cpu")
    assert pipeline_config_from_manifest(manifest) == CFG


def test_session_exact_and_padding(session):
    state = _state(CFG)
    assert (session.batch_size, session.num_points) == (B, N)
    xyz, valid = _scenes(B)
    live = _live(state, xyz, valid, seed=0)
    _equal(session.predict(xyz, valid, seed=0), live)
    m = live["masks"][live["valid"]]
    assert m.any() and not m.all()  # the masks comparison sees both outcomes
    # b=1 < B: padded with copies of the first scene, the padding dropped
    got1 = session.predict(xyz[:1], valid[:1], seed=0)
    assert all(got1[f].shape[0] == 1 for f in FIELDS)
    ref = _live(state, np.concatenate([xyz[:1]] * B), np.concatenate([valid[:1]] * B), seed=0)
    _equal(got1, ref, slice(0, 1))


def test_session_chunks_oversized_batch(session):
    state = _state(CFG)
    xyz, valid = _scenes(2 * B + 1)  # two whole chunks and one padded
    got = session.predict(xyz, valid, seed=3)
    assert all(got[f].shape[0] == 2 * B + 1 for f in FIELDS)
    for ci in range(3):
        lo, hi = ci * B, min(ci * B + B, 2 * B + 1)
        part_x, part_v = xyz[lo:hi], valid[lo:hi]
        pad = B - (hi - lo)
        part_x = np.concatenate([part_x] + [part_x[:1]] * pad)
        part_v = np.concatenate([part_v] + [part_v[:1]] * pad)
        want = _live(state, part_x, part_v, seed=3, chunk=ci)
        for f in FIELDS:
            np.testing.assert_array_equal(got[f][lo:hi], want[f][:hi - lo], err_msg=f"{f} {ci}")


def test_session_input_validation(artifact, session):
    with pytest.raises(ValueError, match="n_points"):
        session.predict(np.zeros((1, N + 8, 3), np.float32))
    with pytest.raises(ValueError, match="without features"):
        session.predict(np.zeros((1, N, 3), np.float32),
                        features=np.zeros((1, N, 4), np.float32))
    with pytest.raises(ValueError, match=r"valid must be"):
        session.predict(np.zeros((1, N, 3), np.float32), valid=np.ones((2, N), bool))
    with pytest.raises(ValueError, match="architecture"):
        InferenceSession(artifact, {k: v for k, v in _state(CFG).items() if "gspn" not in k},
                         device="cpu")


def test_predict_rejects_empty_batch(session):
    with pytest.raises(ValueError, match="at least one scene"):
        session.predict(np.zeros((0, N, 3), np.float32))


def _trained_checkpoints(cfg, tmp_path):
    """``train_gspn``- and ``train_rpointnet``-shaped checkpoints (a GSPN
    with its recognition network, an R-PointNet, each with an optimizer)
    whose weights differ from the seeded ones; returns their directories
    and the pipeline state they stand for."""
    state = _state(cfg, seed=7)
    gspn = GSPN(cfg.gspn, recognition=True)
    gspn.load_state_dict({k[len("gspn."):]: v for k, v in state.items()
                          if k.startswith("gspn.")}, strict=False)
    rpn = RPointNet(cfg.rpointnet)
    rpn.load_state_dict({k[len("rpointnet."):]: v for k, v in state.items()
                         if k.startswith("rpointnet.")})
    dirs = {}
    for name, model in (("gspn", gspn), ("rpointnet", rpn)):
        dirs[name] = tmp_path / name / "ckpt"
        CheckpointManager(dirs[name]).save(TrainState(model, make_optimizer(model, 1e-3), 5))
    return dirs, state


def test_session_from_checkpoints_restores(artifact, tmp_path):
    """A session from the manifest alone serves the checkpoints' weights,
    not the seeded ones; the GSPN checkpoint's recognition network is
    dropped."""
    dirs, trained = _trained_checkpoints(CFG, tmp_path)
    session = session_from_checkpoints(artifact, dirs["gspn"], dirs["rpointnet"], device="cpu")
    xyz, valid = _scenes(B)
    got = session.predict(xyz, valid, seed=0)
    _equal(got, _live(trained, xyz, valid, seed=0))
    seeded = _live(_state(CFG), xyz, valid, seed=0)
    assert not np.array_equal(got["scores"], seeded["scores"])
    # one stage only: the other keeps the seeded weights
    only = session_from_checkpoints(artifact, rpointnet_ckpt=dirs["rpointnet"], device="cpu")
    mixed = {k: (trained if k.startswith("rpointnet.") else _state(CFG))[k] for k in trained}
    _equal(only.predict(xyz, valid, seed=0), _live(mixed, xyz, valid, seed=0))
    with pytest.raises(ValueError, match="does not hold a gspn"):
        session_from_checkpoints(artifact, gspn_ckpt=dirs["rpointnet"], device="cpu")


def test_session_from_checkpoints_no_bn_artifact(tmp_path):
    """A ``use_bn=False`` architecture has no BatchNorm entries; its
    checkpoints restore into the session without them."""
    cfg = dataclasses.replace(CFG, gspn=dataclasses.replace(CFG.gspn, use_bn=False),
                              rpointnet=dataclasses.replace(CFG.rpointnet, use_bn=False))
    model = tpl.PipelineModel(cfg)
    model.load_state_dict(_state(cfg))
    assert not any("running" in k for k in model.state_dict())
    path = save_artifact(tmp_path / "nobn.gspnt",
                         export_inference(cfg, model.eval(), N, batch_size=1, device="cpu"), cfg)
    dirs, trained = _trained_checkpoints(cfg, tmp_path)
    session = session_from_checkpoints(path, dirs["gspn"], device="cpu")
    assert set(session.state) == set(model.state_dict())
    xyz, valid = _scenes(1)
    got = session.predict(xyz, valid, seed=0)
    assert got["masks"].shape == (1, cfg.num_seeds, N)


def test_server_round_trip_unix_socket(session, tmp_path):
    state = _state(CFG)
    xyz, valid = _scenes(B)
    live = _live(state, xyz, valid, seed=0)
    sock = tmp_path / "gspn.sock"
    with Server(session, sock), Client(sock) as client:
        got = client.predict(xyz, valid, seed=0)
        _equal(got, live)
        _equal(got, session.predict(xyz, valid, seed=0))
        assert client.predict(xyz[:1], valid[:1])["masks"].shape[0] == 1
        # a bad request errors on its frame; the connection keeps serving
        with pytest.raises(RuntimeError, match="n_points"):
            client.predict(np.zeros((1, N + 8, 3), np.float32))
        np.testing.assert_array_equal(client.predict(xyz, valid, seed=0)["masks"],
                                      live["masks"])
    assert not sock.exists()  # stop() removes the socket file


def test_client_rejects_stale_frame(session, tmp_path):
    """A late response frame of an aborted request is not read as the
    answer to a new one: the id mismatch poisons the client."""
    xyz, valid = _scenes(B)
    sock = tmp_path / "gspn.sock"
    with Server(session, sock):
        client = Client(sock)
        srt._send_msg(client._sock, {"xyz": np.asarray(xyz, np.float32), "seed": np.int64(0),
                                     "_rid": np.int64(99)})
        with pytest.raises(ConnectionError, match="correlation id"):
            client.predict(xyz, valid, seed=0)
        with pytest.raises(ConnectionError, match="new Client"):
            client.predict(xyz, valid, seed=0)
        with Client(sock) as fresh:
            assert fresh.predict(xyz, valid, seed=0)["masks"].shape[0] == B


def test_server_caps_connections(session, tmp_path):
    xyz, valid = _scenes(B)
    sock = tmp_path / "gspn.sock"
    with Server(session, sock, max_connections=1):
        with Client(sock) as c1:
            assert c1.predict(xyz, valid)["masks"].shape[0] == B
            c2 = Client(sock)  # accepted by the socket, then closed by the server
            time.sleep(0.2)
            with pytest.raises((ConnectionError, OSError)):
                c2.predict(xyz, valid)
        deadline = time.monotonic() + 5
        while True:  # the slot frees once c1 has gone
            try:
                with Client(sock) as c3:
                    assert c3.predict(xyz, valid)["masks"].shape[0] == B
                break
            except (ConnectionError, OSError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)


def test_server_rejects_oversized_request(session, tmp_path):
    sock = tmp_path / "gspn.sock"
    with Server(session, sock, max_request_scenes=1) as srv:
        client = Client(sock)
        client._sock.sendall(srt._HEADER.pack(srt._MAGIC, srt._VERSION,
                                              srv.max_request_bytes + 1))
        with pytest.raises((ConnectionError, OSError)):
            client._sock.sendall(b"\0" * (1 << 20))
            if client._sock.recv(1) == b"":
                raise ConnectionError("closed")


def test_server_concurrent_clients(session, tmp_path):
    """More clients than cores at once, with the interpreter switching
    threads often: every answer is the live one (the session's lock keeps
    one request's device work from mixing with another's)."""
    xyz, valid = _scenes(B)
    live = _live(_state(CFG), xyz, valid, seed=0)
    sock = tmp_path / "gspn.sock"
    results, errors = {}, []

    def worker(i):
        try:
            with Client(sock) as c:
                results[i] = c.predict(xyz, valid, seed=0)
        except Exception as e:  # raised again in the main thread
            errors.append(e)

    clients = (os.cpu_count() or 4) + 2
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with Server(session, sock, max_connections=clients):
            threads = [threading.Thread(target=worker, args=(i,)) for i in range(clients)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert sorted(results) == list(range(clients))
    for r in results.values():
        _equal(r, live)


def test_jax_client_against_port_server(session, tmp_path):
    """The wire format is the JAX package's byte for byte: its ``Client``
    gets the port's answers."""
    from gspn_tpu.serve import Client as JaxClient

    xyz, valid = _scenes(B)
    sock = tmp_path / "gspn.sock"
    with Server(session, sock), JaxClient(sock) as client:
        got = client.predict(xyz, valid, seed=4)
    _equal(got, session.predict(xyz, valid, seed=4))


def test_port_client_against_jax_server(tmp_path):
    from gspn_tpu.models.pipeline import init_pipeline_variables
    from gspn_tpu.serve import InferenceSession as JaxSession
    from gspn_tpu.serve import Server as JaxServer
    from gspn_tpu.serve import export_inference as jax_export
    from gspn_tpu.serve import save_artifact as jax_save

    variables = init_pipeline_variables(TINY, jax.random.PRNGKey(0), N)
    path = jax_save(tmp_path / "tiny.gspnx", jax_export(TINY, variables, N, batch_size=B), TINY)
    session = JaxSession(path, variables)
    xyz, valid = _scenes(B)
    sock = tmp_path / "gspn.sock"
    with JaxServer(session, sock), Client(sock) as client:
        got = client.predict(xyz, valid, seed=2)
    _equal(got, session.predict(xyz, valid, seed=2))


def test_exported_program_matches_jax_make_inference_fn(tmp_path):
    """The port's exported program on the frozen fixture's weights and
    scenes, fed the noise JAX's ``infer`` draws from ``PRNGKey(1)``, against
    JAX's ``make_inference_fn``: masks, valid and classes equal; scores and
    boxes within the fixtures' tolerances."""
    from gspn_tpu.models import pipeline as jpl

    z = _load("instance_inference.npz")
    jcfg = dataclasses.replace(TINY, mask_thresh=0.47)
    variables = _base_pipeline_variables(z)
    xyz, valid = z["in/xyz"], z["in/valid"]
    want = jpl.make_inference_fn(jcfg)(variables, jnp.asarray(xyz), None, jnp.asarray(valid),
                                       jax.random.PRNGKey(1))
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                       (xyz.shape[0], jcfg.num_seeds, jcfg.gspn.latent_dim)))
    cfg = pipeline_config(jcfg)
    model = tpl.PipelineModel(cfg)
    model.load_state_dict(convert.pipeline_state_dict(as_numpy_tree(variables)))
    program = export_inference(cfg, model.eval(), xyz.shape[1], batch_size=xyz.shape[0],
                               device="cpu")
    program, _ = load_artifact(save_artifact(tmp_path / "fx.gspnt", program, cfg), "cpu")
    with torch.inference_mode():
        got = dict(zip(FIELDS, program.module()(sx.serving_state(model), t(xyz), t(valid),
                                                t(eps))))
    for f in ("masks", "valid", "classes"):
        np.testing.assert_array_equal(n(got[f]), np.asarray(getattr(want, f)), err_msg=f)
    for f in ("scores", "boxes"):
        np.testing.assert_allclose(n(got[f]), np.asarray(getattr(want, f)), rtol=1e-4,
                                   atol=1e-5, err_msg=f)
    m = n(got["masks"])[n(got["valid"])]
    assert m.any() and not m.all()


def test_command_lines_export_and_serve(tmp_path):
    """``python -m gspn_tpu_torch.serve.export_serving`` (``--verify``) writes
    a CPU artifact, ``serve_gspnx`` serves it from the trainers'
    checkpoints, and a ``Client`` gets the session's answer; the unported
    flags raise quoting their ROADMAP entry, and the default device needs a
    card."""
    from gspn_tpu_torch.models.presets import scale_pipeline_widths
    from gspn_tpu_torch.serve import export_serving, serve_gspnx
    from gspn_tpu_torch.train.train_gspn import TINY_GSPN
    from gspn_tpu_torch.train.train_rpointnet import tiny_rpointnet

    args = ["--device", "cpu", "--preset", "tiny", "--batch", "2", "--num-points", "256",
            "--num-seeds", "8", "--num-classes", "3"]
    out = export_serving.main([*args, "--out", str(tmp_path / "t.gspnt"), "--verify"])
    cfg = pipeline_config_from_manifest(load_artifact(out, "cpu")[1])
    assert cfg.gspn == TINY_GSPN and cfg.rpointnet == tiny_rpointnet(3)
    dirs, _ = _trained_checkpoints(cfg, tmp_path)
    sock = tmp_path / "gspn.sock"
    stop = threading.Event()
    argv = ["--device", "cpu", "--artifact", str(out), "--gspn-ckpt", str(dirs["gspn"]),
            "--rpointnet-ckpt", str(dirs["rpointnet"]), "--socket", str(sock)]
    server = threading.Thread(target=serve_gspnx.main, args=(argv, stop))
    server.start()
    try:
        deadline = time.monotonic() + 60
        while not sock.exists():
            assert time.monotonic() < deadline and server.is_alive()
            time.sleep(0.05)
        sb = synthetic.scene_batch(np.random.default_rng(0), 3, n_points=256, max_instances=3,
                                   extent=2.0)
        with Client(sock) as client:
            got = client.predict(sb["xyz"], sb["valid"], seed=1)
    finally:
        stop.set()
        server.join(timeout=30)
    assert not server.is_alive() and not sock.exists()
    session = session_from_checkpoints(out, dirs["gspn"], dirs["rpointnet"], device="cpu")
    _equal(got, session.predict(sb["xyz"], sb["valid"], seed=1))
    wide = export_serving.main([*args, "--width-mult", "2", "--out", str(tmp_path / "w.gspnt")])
    assert pipeline_config_from_manifest(load_artifact(wide, "cpu")[1]) == scale_pipeline_widths(
        cfg, 2)
    for flags in (["--dtype", "bf16"], ["--feature-dim", "3"], ["--platform", "cpu"]):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            export_serving.main([*args, *flags, "--out", str(tmp_path / "x.gspnt")])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            export_serving.main(["--out", str(tmp_path / "x.gspnt")])
