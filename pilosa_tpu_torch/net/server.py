"""Server — one node: holder + executor + HTTP front end.

``Server(data_dir, host, device=...)`` opens the data directory (the
layout of ``pilosa_tpu.net.server``'s), serves the JSON API of
net/handler.py on a ThreadingHTTPServer, and keeps every fragment's
device mirror on ``device`` — the CUDA card unless the caller passes
``device="cpu"``; asking for CUDA where there is none raises.

Cluster membership, gossip, anti-entropy and the background loops of
the JAX server are not ported yet: this is a single node.
"""

from __future__ import annotations

import threading

import torch

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.exec.executor import DEFAULT_MAX_WRITES_PER_REQUEST, Executor
from pilosa_tpu_torch.net.handler import Handler, make_http_server


class Server:
    def __init__(
        self,
        data_dir: str,
        host: str = "127.0.0.1:0",
        device: torch.device | str | None = None,
        max_writes_per_request: int = DEFAULT_MAX_WRITES_PER_REQUEST,
    ):
        self.device = device_mod.resolve(device)
        self.host = host
        self.holder = Holder(data_dir, device=self.device)
        self.executor = Executor(self.holder, max_writes_per_request=max_writes_per_request)
        self.handler = Handler(self.holder, self.executor, host=host)
        self._http = None
        self._http_thread: threading.Thread | None = None

    def open(self) -> None:
        self.holder.open()
        bind_host, _, bind_port = self.host.rpartition(":")
        port = int(bind_port or 0)
        self._http = make_http_server(self.handler, bind_host or "127.0.0.1", port)
        if port == 0:
            addr = self._http.server_address
            self.host = f"{bind_host or addr[0]}:{addr[1]}"
        self.handler.host = self.host
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, daemon=True, name=f"http:{self.host}"
        )
        self._http_thread.start()

    def close(self) -> None:
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None
        if self._http_thread is not None:
            self._http_thread.join(timeout=10)
            self._http_thread = None
        self.holder.close()

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, *exc):
        self.close()
