"""Serve an exported artifact over a socket.

The port's counterpart of ``scripts/serve_gspnx.py``, with the same flags
plus ``--device`` (default ``cuda``). The serving host needs this module,
the artifact and the checkpoints: the pipeline config comes from the
artifact's manifest (``serve/runtime.py``)::

    python -m gspn_tpu_torch.serve.serve_gspnx --artifact model.gspnt \\
        --gspn-ckpt runs/s1/ckpt --rpointnet-ckpt runs/s2/ckpt \\
        --socket /tmp/gspn.sock            # or: --port 7447 (loopback)

    # any client process, of this package or of the JAX one:
    from gspn_tpu_torch.serve import Client
    with Client("/tmp/gspn.sock") as c:    # or Client(("host", 7447))
        out = c.predict(xyz)               # a dict of numpy arrays

A request of any batch size is padded or chunked to the artifact's
batch by the session. The protocol carries no authentication: bind unix
sockets or loopback or trusted interfaces only (the default ``--host`` is
127.0.0.1).
"""

from __future__ import annotations

import argparse
import threading


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="serve an exported artifact")
    p.add_argument("--artifact", required=True)
    p.add_argument("--gspn-ckpt", default=None)
    p.add_argument("--rpointnet-ckpt", default=None)
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--socket", default=None, help="unix-domain socket path")
    g.add_argument("--port", type=int, default=None, help="TCP port")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu: the artifact's platform")
    return p.parse_args(argv)


def main(argv=None, stop: threading.Event | None = None):
    """Serve until interrupted, or until ``stop`` is set."""
    args = parse_args(argv)
    from gspn_tpu_torch.serve.runtime import Server, session_from_checkpoints
    from gspn_tpu_torch.train.train_gspn import resolve_device

    device = resolve_device(args.device, "serve_gspnx")
    session = session_from_checkpoints(args.artifact, args.gspn_ckpt, args.rpointnet_ckpt,
                                       device=device)
    address = args.socket if args.socket else (args.host, args.port)
    with Server(session, address) as server:
        print(f"serving {args.artifact} (batch={session.batch_size}, "
              f"n_points={session.num_points}, platforms={session.manifest['platforms']}) "
              f"on {server.address}", flush=True)
        try:
            (stop or threading.Event()).wait()
        except KeyboardInterrupt:
            pass


if __name__ == "__main__":
    main()
