"""The web console on a port node against a JAX node's.

``GET /`` and every ``GET /assets/<file>`` of ``pilosa_tpu_torch/net/
webui.py`` answer the JAX node's bytes, status and content type; an
unknown asset answers 404 on both; and ``tests/test_net.py::test_webui``'s
assertions hold on a port node.
"""

import pytest

pytest.importorskip("torch")

from pilosa_tpu.net import webui as jwebui  # noqa: E402
from pilosa_tpu.net.server import Server as JServer  # noqa: E402
from pilosa_tpu_torch.net import webui as twebui  # noqa: E402
from pilosa_tpu_torch.net.client import InternalClient  # noqa: E402
from pilosa_tpu_torch.net.server import Server  # noqa: E402


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("webui")
    j = JServer(data_dir=str(d / "jax"), host="127.0.0.1:0", admission=False,
                anti_entropy_interval=3600, polling_interval=3600, cache_flush_interval=3600)
    t = Server(str(d / "torch"), host="127.0.0.1:0", device="cpu", floor_probe=False,
               anti_entropy_interval=3600, polling_interval=3600)
    j.open()
    t.open()
    try:
        yield j, t
    finally:
        t.close()
        j.close()


def _get(host: str, path: str) -> tuple[int, str, bytes]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://{host}{path}", timeout=10) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_assets_are_the_jax_modules():
    assert twebui.INDEX_HTML == jwebui.INDEX_HTML
    assert twebui.ASSETS == jwebui.ASSETS


@pytest.mark.parametrize("path", ["/"] + [f"/assets/{name}" for name in sorted(jwebui.ASSETS)]
                         + ["/assets/nope.js"])
def test_route_answers_the_jax_bytes(pair, path):
    j, t = pair
    got, want = _get(t.host, path), _get(j.host, path)
    assert got == want
    assert want[0] == (404 if path.endswith("nope.js") else 200)


def test_webui(pair):
    """``tests/test_net.py::test_webui`` against a port node."""
    _, t = pair
    client = InternalClient(t.host, timeout=10.0)
    status, data = client._request("GET", "/")
    assert status == 200 and b"pilosa-tpu" in data
    # The console shell carries the three interface areas the
    # reference console has: REPL, index dropdown, cluster pane.
    for marker in (b'id="query"', b'id="index-dropdown"', b'id="pane-cluster"'):
        assert marker in data, marker
    status, data = client._request("GET", "/assets/main.js")
    assert status == 200
    # Feature markers: REPL history, tab completion, meta commands,
    # cluster rendering (reference: webui/assets/main.js).
    for marker in (b"class Repl", b"completeAtCursor", b"parseMeta",
                   b"refreshCluster"):
        assert marker in data, marker
    status, data = client._request("GET", "/assets/main.css")
    assert status == 200
    status, _ = client._request("GET", "/assets/nope.js")
    assert status == 404
