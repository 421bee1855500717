"""Serving runtime: run an exported artifact behind a socket server.

The port's counterpart of ``gspn_tpu/serve/runtime.py``:

- :class:`InferenceSession` holds a loaded artifact and a state dict and
  serves ``predict()`` with the request hygiene a bare program call lacks:
  a batch smaller than the compiled one is padded by replicating its first
  scene (the padding rows are dropped on return), a larger one is chunked,
  the inputs are validated, and the device work sits behind a lock, so
  one session serves many threads. On the card it replays the program from
  a CUDA graph (``utils.cuda_graph.GraphedRequest``) at the compiled
  shape, the counterpart of the JAX package's one compiled program; on
  the CPU it calls the program.
- :func:`session_from_checkpoints` builds the session from the artifact's
  own manifest: the pipeline config read back
  (``train.config_io.config_from_jsonable``), seeded weights of that
  architecture, and the stage checkpoints of ``train_gspn`` and
  ``train_rpointnet`` restored over them.
- :class:`Server` / :class:`Client`: the JAX package's wire protocol, byte
  for byte (a ``>4sBI`` header of magic ``GSPN``, version 2 and the
  payload's length, then an ``np.savez`` payload), over a unix-domain or
  TCP socket, so either package's client talks to either's server. One
  accept thread, one handler thread a connection (at most
  ``max_connections``), a request size cap from the compiled shape, and
  each response echoing the request's ``_rid``.

The noise of a request's chunk ``ci`` comes from a generator seeded from
``(seed, ci)`` alone (:func:`chunk_noise`), so an answer depends on the
input and the seed, not on how the batch was chunked or which device ran
it. The JAX session draws from ``fold_in(PRNGKey(seed), ci)`` instead, so
the two agree only when the same noise is fed to both programs.

Security model: the protocol carries no authentication. Serve on a unix
socket or a loopback or trusted interface only.
"""

from __future__ import annotations

import contextlib
import io
import pathlib
import socket
import struct
import threading

import numpy as np
import torch

from gspn_tpu_torch.models.gspn import GSPNConfig
from gspn_tpu_torch.models.pipeline import (
    PREDICTION_FIELDS,
    PipelineConfig,
    PipelineModel,
    check_supported,
    init_pipeline_variables,
)
from gspn_tpu_torch.models.rpointnet import RPointNetConfig, SALayerSpec
from gspn_tpu_torch.serve.export import load_artifact
from gspn_tpu_torch.train.config_io import config_from_jsonable
from gspn_tpu_torch.train.train_gspn import step_generator
from gspn_tpu_torch.utils.cuda_graph import GraphedRequest

_MAGIC = b"GSPN"
_VERSION = 2  # responses echo the request's _rid (the JAX package's version 2)
_HEADER = struct.Struct(">4sBI")  # magic, version, payload length
# the absolute frame ceiling (a response to a large chunked batch can be
# big); a Server also caps requests at a size from the compiled shape
_MAX_PAYLOAD = 1 << 31


def pipeline_config_from_manifest(manifest: dict) -> PipelineConfig:
    """The :class:`PipelineConfig` an artifact's manifest holds."""
    registry = {c.__name__: c for c in (PipelineConfig, GSPNConfig, RPointNetConfig, SALayerSpec)}
    return config_from_jsonable(manifest["pipeline_config"], registry)


def chunk_noise(seed: int, chunk: int, shape) -> torch.Tensor:
    """The CVAE noise of chunk ``chunk`` of a request seeded ``seed``: one
    float32 draw of ``shape`` on the CPU from a generator seeded from
    ``(seed, chunk)`` alone (``train_gspn.step_generator``'s seeding)."""
    gen = step_generator(seed, chunk, "cpu")
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32)


@contextlib.contextmanager
def float32_matmuls():
    """TF32 off for matmuls and cuDNN while the program runs (and while it
    is captured): a TF32 product can flip a mask threshold."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class InferenceSession:
    """A loaded artifact ready to serve on ``device``.

    ``state`` is a state dict of the artifact's architecture (a
    ``PipelineModel``'s, as :func:`session_from_checkpoints` builds it);
    it is moved to ``device`` and passed to the program in the
    architecture's key order. ``loaded`` takes an already loaded
    ``(program, manifest)``. On the card the constructor captures one
    request at the compiled shape; a capture that fails raises."""

    def __init__(self, artifact: str | pathlib.Path | None, state: dict, *, device="cuda",
                 loaded: tuple | None = None):
        self.device = torch.device(device)
        self.program, self.manifest = (loaded if loaded is not None
                                       else load_artifact(artifact, self.device))
        self.config = pipeline_config_from_manifest(self.manifest)
        check_supported(self.config)
        keys = PipelineModel(self.config).state_dict().keys()
        if set(state) != set(keys):
            missing, extra = sorted(set(keys) - set(state)), sorted(set(state) - set(keys))
            raise ValueError(f"state does not match the artifact's architecture: missing "
                             f"{missing[:5]}, unexpected {extra[:5]}")
        self.state = {k: state[k].to(self.device) for k in keys}
        self.batch_size, self.num_points = self.manifest["inputs"]["xyz"][:2]
        self.noise_shape = tuple(self.manifest["inputs"]["z_eps"])
        self._lock = threading.Lock()
        self.module = self.program.module()
        self._graphed = None
        if self.device.type == "cuda":
            with torch.inference_mode(), float32_matmuls():
                example = (torch.zeros((self.batch_size, self.num_points, 3), device=self.device),
                           torch.ones((self.batch_size, self.num_points), dtype=torch.bool,
                                      device=self.device),
                           torch.zeros(self.noise_shape, device=self.device))
                self._graphed = GraphedRequest(self._call, *example)

    def _call(self, xyz, valid, z_eps):
        return self.module(self.state, xyz, valid, z_eps)

    def run(self, xyz: torch.Tensor, valid: torch.Tensor, z_eps: torch.Tensor):
        """One request at the compiled shape, tensors on the session's
        device: the graph's replay on the card, the program on the CPU.
        Returns ``(masks, scores, classes, boxes, valid)``."""
        with self._lock, torch.inference_mode(), float32_matmuls():
            if self._graphed is not None:
                return self._graphed(xyz, valid, z_eps)
            return self._call(xyz, valid, z_eps)

    def predict(self, xyz: np.ndarray, valid: np.ndarray | None = None,
                features: np.ndarray | None = None, seed: int = 0) -> dict[str, np.ndarray]:
        """Inference on ``xyz (b, n, 3)`` for any ``b >= 1``; ``n`` must be
        the artifact's point count. Returns numpy ``masks``, ``scores``,
        ``classes``, ``boxes`` and ``valid`` with a leading ``b``. Chunk
        ``ci`` of the batch (``batch_size`` scenes, the last padded)
        takes :func:`chunk_noise` ``(seed, ci)``."""
        xyz = np.asarray(xyz, np.float32)
        if xyz.ndim != 3 or xyz.shape[-1] != 3:
            raise ValueError(f"xyz must be (b, n, 3), got {xyz.shape}")
        b, n = xyz.shape[:2]
        if b < 1:
            raise ValueError("xyz must contain at least one scene (b >= 1)")
        if n != self.num_points:
            raise ValueError(f"artifact was exported for n_points={self.num_points}, got {n}; "
                             "re-export for this size")
        valid = np.ones((b, n), bool) if valid is None else np.asarray(valid, bool)
        if valid.shape != (b, n):
            raise ValueError(f"valid must be {(b, n)}, got {valid.shape}")
        if features is not None:
            raise ValueError("artifact was exported without features")

        outs = []
        bs = self.batch_size
        for ci, lo in enumerate(range(0, b, bs)):
            take = min(bs, b - lo)

            def chunk(a):
                # pad with copies of the chunk's first scene: always a
                # well-formed scene; the padding rows are dropped below
                part = a[lo:lo + take]
                return torch.from_numpy(np.concatenate([part, np.repeat(part[:1], bs - take, 0)]))

            preds = self.run(chunk(xyz).to(self.device), chunk(valid).to(self.device),
                             chunk_noise(seed, ci, self.noise_shape).to(self.device))
            outs.append([p[:take].cpu().numpy() for p in preds])
        return {f: np.concatenate(parts) for f, parts in zip(PREDICTION_FIELDS, zip(*outs))}


def session_from_checkpoints(artifact: str | pathlib.Path, gspn_ckpt: str | None = None,
                             rpointnet_ckpt: str | None = None, *,
                             device="cuda") -> InferenceSession:
    """A ready session from the artifact's own manifest: the pipeline
    config read back, seeded weights of that architecture
    (``init_pipeline_variables`` from ``torch.Generator().manual_seed(0)``),
    and the newest checkpoint under ``gspn_ckpt`` (a ``train_gspn`` run's
    ``{log_dir}/ckpt``: its recognition network's entries, which inference
    does not use, dropped) and under ``rpointnet_ckpt`` (a
    ``train_rpointnet`` run's) restored over them. The artifact is read
    once."""
    loaded = load_artifact(artifact, device)
    cfg = pipeline_config_from_manifest(loaded[1])
    state = init_pipeline_variables(cfg, torch.Generator().manual_seed(0),
                                    loaded[1]["inputs"]["xyz"][1])
    restore_checkpoints(state, gspn_ckpt, rpointnet_ckpt)
    return InferenceSession(artifact, state, device=device, loaded=loaded)


def restore_checkpoints(state: dict, gspn_ckpt: str | None = None,
                        rpointnet_ckpt: str | None = None) -> dict:
    """Overwrite a ``PipelineModel`` state dict's ``gspn.*`` entries with
    the newest ``train_gspn`` checkpoint under ``gspn_ckpt`` (without the
    recognition network, which inference does not use) and its
    ``rpointnet.*`` entries with the newest ``train_rpointnet`` checkpoint
    under ``rpointnet_ckpt``; ``ValueError`` unless a checkpoint holds
    exactly its stage's entries at their shapes. Returns ``state``."""
    from gspn_tpu_torch.convert import GSPN_TRAINING_ONLY
    from gspn_tpu_torch.train.checkpoint import latest_model_state

    for name, ckpt in (("gspn", gspn_ckpt), ("rpointnet", rpointnet_ckpt)):
        if not ckpt:
            continue
        restored = {f"{name}.{k}": v for k, v in latest_model_state(ckpt).items()
                    if not (name == "gspn" and k.split(".")[0] in GSPN_TRAINING_ONLY)}
        stage = {k for k in state if k.startswith(f"{name}.")}
        if set(restored) != stage:
            raise ValueError(f"{ckpt} does not hold a {name} of the artifact's architecture: "
                             f"missing {sorted(stage - set(restored))[:5]}, unexpected "
                             f"{sorted(set(restored) - stage)[:5]}")
        for k, v in restored.items():
            if v.shape != state[k].shape:
                raise ValueError(f"{ckpt}: {k} has shape {tuple(v.shape)}, the artifact's "
                                 f"architecture {tuple(state[k].shape)}")
        state.update(restored)
    return state


# ---------------------------------------------------------------------------
# wire protocol


def _send_msg(sock: socket.socket, arrays: dict[str, np.ndarray]) -> None:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    sock.sendall(_HEADER.pack(_MAGIC, _VERSION, len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    chunks = []
    while n:
        c = sock.recv(min(n, 1 << 20))
        if not c:
            return None
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _recv_msg(sock: socket.socket, max_len: int = _MAX_PAYLOAD) -> dict[str, np.ndarray] | None:
    head = _recv_exact(sock, _HEADER.size)
    if head is None:
        return None
    magic, version, length = _HEADER.unpack(head)
    if magic != _MAGIC:
        raise ValueError(f"bad frame magic {magic!r}")
    if version != _VERSION:
        raise ValueError(f"unsupported protocol version {version}")
    if length > max_len:
        raise ValueError(f"oversized payload ({length} > {max_len} bytes)")
    payload = _recv_exact(sock, length)
    if payload is None:
        raise ValueError("connection closed mid-frame")
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class Server:
    """A threaded socket server around one :class:`InferenceSession`.

    ``address`` is a unix-socket path or a ``(host, port)`` pair. A
    connection sends request frames until it closes; a request that fails
    gets an ``{"error": message}`` frame and the connection stays up,
    while a malformed frame closes it. ``max_connections`` caps the
    handler threads (a connection beyond it is closed at accept), and
    ``max_request_scenes`` caps a request frame at that many scenes of the
    compiled shape."""

    def __init__(self, session: InferenceSession, address, max_connections: int = 16,
                 max_request_scenes: int = 1024):
        self.session = session
        self._conn_sem = threading.BoundedSemaphore(max_connections)
        # a scene's xyz in float32, its valid flags (a bit each up to an
        # int64 from a sloppy client) and the container's overhead
        per_scene = session.num_points * (3 * 4 + 8) + 4096
        self.max_request_bytes = min(_MAX_PAYLOAD, max_request_scenes * per_scene + (1 << 20))
        self._unix_path = None
        if isinstance(address, (str, pathlib.Path)):
            self._unix_path = pathlib.Path(address)
            if self._unix_path.exists():
                self._unix_path.unlink()
            self._listener = socket.socket(socket.AF_UNIX)
            self._listener.bind(str(self._unix_path))
        else:
            self._listener = socket.socket(socket.AF_INET)
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listener.bind(tuple(address))
        self._listener.listen(16)
        self._stop = threading.Event()
        self._accept_thread: threading.Thread | None = None

    @property
    def address(self):
        return str(self._unix_path) if self._unix_path else self._listener.getsockname()

    def start(self) -> Server:
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True,
                                               name="gspn-serve-accept")
        self._accept_thread.start()
        return self

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # the listener was closed by stop()
            if not self._conn_sem.acquire(blocking=False):
                conn.close()  # over max_connections: refuse
                continue
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()

    def _handle(self, conn: socket.socket):
        try:
            with conn:
                while not self._stop.is_set():
                    try:
                        req = _recv_msg(conn, self.max_request_bytes)
                    except (ValueError, OSError):
                        return
                    if req is None:
                        return
                    rid = req.pop("_rid", None)
                    try:
                        out = self.session.predict(req["xyz"], valid=req.get("valid"),
                                                   features=req.get("features"),
                                                   seed=int(req.get("seed", 0)))
                    except Exception as e:  # an error frame; the connection keeps serving
                        out = {"error": np.array(str(e))}
                    if rid is not None:
                        # echo the request id, so a client can reject a
                        # stale frame an aborted request left queued
                        out["_rid"] = np.asarray(rid)
                    try:
                        _send_msg(conn, out)
                    except OSError:
                        return
        finally:
            self._conn_sem.release()

    def stop(self):
        self._stop.set()
        self._listener.close()
        if self._accept_thread:
            self._accept_thread.join(timeout=5)
        if self._unix_path and self._unix_path.exists():
            self._unix_path.unlink()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class Client:
    """A blocking client of :class:`Server`'s protocol (and of the JAX
    package's server).

    Every request carries a fresh ``_rid``, which the server echoes; a
    missing or other echo (a stale frame of an aborted request) is an
    error. A timeout or transport error poisons the client: its socket is
    closed and every later call raises ``ConnectionError``, because the
    stream may still hold a late response. Reconnect (a new Client) to
    retry. ``timeout`` must cover the server's first request."""

    def __init__(self, address, timeout: float | None = 300.0):
        self._dead = False  # poisoned by a timeout or transport error
        self._closed = False  # closed by close()
        self._next_rid = 0
        if isinstance(address, (str, pathlib.Path)):
            self._sock = socket.socket(socket.AF_UNIX)
            self._sock.settimeout(timeout)
            self._sock.connect(str(address))
        else:
            self._sock = socket.create_connection(tuple(address), timeout=timeout)

    def predict(self, xyz: np.ndarray, valid: np.ndarray | None = None,
                features: np.ndarray | None = None, seed: int = 0) -> dict[str, np.ndarray]:
        if self._dead:
            raise ConnectionError("client connection is closed after a previous "
                                  "timeout/transport error; create a new Client")
        if self._closed:
            raise ConnectionError("client is closed; create a new Client")
        rid = self._next_rid
        self._next_rid += 1
        req = {"xyz": np.asarray(xyz, np.float32), "seed": np.int64(seed), "_rid": np.int64(rid)}
        if valid is not None:
            req["valid"] = np.asarray(valid, bool)
        if features is not None:
            req["features"] = np.asarray(features, np.float32)
        try:
            _send_msg(self._sock, req)
            resp = _recv_msg(self._sock)
        except (OSError, ValueError):
            self._poison()
            raise
        if resp is None:
            self._poison()
            raise ConnectionError("server closed the connection")
        if int(resp.pop("_rid", -1)) != rid:
            self._poison()
            raise ConnectionError("response correlation id mismatch (stale frame from an "
                                  "aborted request); create a new Client")
        if "error" in resp:
            raise RuntimeError(f"server error: {resp['error']}")
        return resp

    def _poison(self):
        self._dead = self._closed = True
        self._sock.close()

    def close(self):
        self._closed = True
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
