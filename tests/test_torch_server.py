"""The websocket server, port against reference (CPU):
exllamav2_tpu_torch/server/websocket.py against
exllamav2_tpu/server/websocket.py, each over its own package's generator on
the trained fixture (greedy requests: decisive argmaxes).

* Every action through dispatch with an in-process connection (an object
  with an async send): exactly the reference's messages, chunks and the
  full response of a single infer included.
* The reference's fault, which the port does not copy: with two infer
  requests in flight, each request's loop drops the results of the other's
  job, so the joined chunks part from the text each prompt gives alone
  (shown with the reference's iterate calls run one at a time, so the test
  shows the routing fault alone and not a thread race). The port's server
  routes every result to its request: each text equals the prompt's own.
* stop: with a request_id it ends that request only, without one every
  request of its connection; the stopped jobs are cancelled in the
  generator and their pages return to the pool.
* A real websockets round trip on localhost.
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch

from exllamav2_tpu.cache_paged import PagedKVCache as RefPagedKVCache
from exllamav2_tpu.generator.dynamic import DynamicGenerator as RefGenerator
from exllamav2_tpu.generator.sampler import Settings as RefSettings
from exllamav2_tpu.models.model import Model as RefModel
from exllamav2_tpu.server import websocket as RW
from exllamav2_tpu.tokenizer import ByteTokenizer as RefByteTokenizer

from exllamav2_tpu_torch.cache_paged import PagedKVCache
from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator
from exllamav2_tpu_torch.generator.sampler import Settings
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.server.websocket import WebSocketServer
from exllamav2_tpu_torch.tokenizer import ByteTokenizer

TRAINED = os.path.join(os.path.dirname(__file__), "fixtures", "trained_tiny")
GREEDY = {"top_k": 1, "temperature": 1.0, "top_p": 0.0, "rep_pen": 1.0}
PROMPTS = ("The quick brown fox", "def main(", "import numpy as")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Conn:
    """An in-process connection: what the server sends, decoded."""

    def __init__(self):
        self.sent = []

    async def send(self, message: str):
        self.sent.append(json.loads(message))
        await asyncio.sleep(0)


@pytest.fixture(scope="module")
def ref_gen():
    m = RefModel.from_dir(TRAINED)
    st = m.static
    cache = RefPagedKVCache.alloc(st.num_layers, 16, st.num_kv_heads,
                                  st.head_dim, "bf16")
    return RefGenerator(m, cache, RefByteTokenizer(384), max_seq_len=512)


@pytest.fixture(scope="module")
def model():
    return Model.from_dir(TRAINED, device="cpu")


def _port_gen(model):
    st = model.static
    cache = PagedKVCache.alloc(st.num_layers, 16, st.num_kv_heads,
                               st.head_dim, "bf16", device="cpu")
    return DynamicGenerator(model, cache, ByteTokenizer(384),
                            max_seq_len=512)


def _alone(gen, prompt, new):
    ids = gen.tokenizer.encode(prompt)
    return gen.generate(ids, max_new_tokens=new, settings=Settings.greedy())


def _infer(prompt, new, rid=None, **kw):
    r = {"action": "infer", "text": prompt, "max_new_tokens": new, **GREEDY,
         **kw}
    if rid is not None:
        r["request_id"] = rid
    return r


def _by_request(sent, rid):
    chunks = [m["chunk"] for m in sent if m.get("request_id") == rid
              and m.get("response_type") == "chunk"]
    full = [m for m in sent if m.get("request_id") == rid
            and m.get("response_type") == "full"]
    assert len(full) == 1
    return "".join(chunks), full[0]["response"]


REQUESTS = [
    {"action": "echo", "request_id": 7, "response_id": "x"},
    {"action": "estimate_token", "text": "hello world", "request_id": 1},
    {"action": "lefttrim_token", "text": "abcdefghij", "max_tokens": 4},
    {"action": "lefttrim_token", "text": "héllo wörld", "max_tokens": 6,
     "response_id": 2},
    {"action": "bogus", "request_id": "z"},
    {"action": "stop"},
    _infer(PROMPTS[0], 12, rid="r1", response_id="q"),
    _infer(PROMPTS[1], 10, stream=False),
    _infer(PROMPTS[2], 8, rid="r3", stop_conditions=[" "]),
]


@pytest.mark.parametrize("request_", REQUESTS,
                         ids=[f"{r['action']}{i}" for i, r in
                              enumerate(REQUESTS)])
def test_dispatch_matches_reference(ref_gen, model, request_):
    ref_server = RW.WebSocketServer(ref_gen)
    server = WebSocketServer(_port_gen(model))
    want, got = Conn(), Conn()
    asyncio.run(ref_server.dispatch(dict(request_), want))
    asyncio.run(server.dispatch(dict(request_), got))
    assert got.sent == want.sent
    assert len(got.sent) >= 1


async def _serialized_to_thread(fn, *a):
    """asyncio.to_thread for the reference, one call at a time: a yield to
    the loop, then the call."""
    await asyncio.sleep(0)
    return fn(*a)


def test_two_requests_in_flight(ref_gen, model, monkeypatch):
    new = 24
    alone = [_alone(_port_gen(model), p, new) for p in PROMPTS[:2]]
    ref_alone = [ref_gen.generate(ref_gen.tokenizer.encode(p),
                                  max_new_tokens=new,
                                  settings=RefSettings.greedy())
                 for p in PROMPTS[:2]]
    assert alone == ref_alone

    async def both(server):
        conns = [Conn(), Conn()]
        await asyncio.gather(*(
            server.dispatch(_infer(p, new, rid=i), c)
            for i, (p, c) in enumerate(zip(PROMPTS[:2], conns))))
        return [_by_request(c.sent, i) for i, c in enumerate(conns)]

    with monkeypatch.context() as m:
        m.setattr(RW.asyncio, "to_thread", _serialized_to_thread)
        ref = asyncio.run(both(RW.WebSocketServer(ref_gen)))
    # the reference: each request swallowed the other's chunks
    for (joined, full), text in zip(ref, alone):
        assert joined == full
        assert full != text and len(full) < len(text)

    gen = _port_gen(model)
    got = asyncio.run(both(WebSocketServer(gen)))
    for (joined, full), text in zip(got, alone):
        assert joined == full == text
    assert gen.num_remaining_jobs() == 0


def _free(gen):
    return gen._free_capacity()


async def _wait_chunk(conn, rid):
    while not any(m.get("request_id") == rid and
                  m.get("response_type") == "chunk" for m in conn.sent):
        await asyncio.sleep(0.001)


def test_stop_with_request_id_ends_that_request(model):
    gen = _port_gen(model)
    free0 = _free(gen)
    server = WebSocketServer(gen)
    short = 12
    text_b = _alone(_port_gen(model), PROMPTS[1], short)

    async def run():
        conn = Conn()
        long_ = asyncio.create_task(server.dispatch(
            _infer(PROMPTS[0], 400, rid="a"), conn))
        other = asyncio.create_task(server.dispatch(
            _infer(PROMPTS[1], short, rid="b"), conn))
        await _wait_chunk(conn, "a")
        await server.dispatch({"action": "stop", "request_id": "a"}, conn)
        await asyncio.gather(long_, other)
        return conn.sent

    sent = asyncio.run(run())
    assert {"action": "stop", "request_id": "a"} in sent
    joined_a, full_a = _by_request(sent, "a")
    joined_b, full_b = _by_request(sent, "b")
    assert joined_a == full_a and 0 < len(full_a) < 400
    assert joined_b == full_b == text_b
    assert gen.num_remaining_jobs() == 0 and _free(gen) == free0


def test_stop_ends_only_its_connections_requests(model):
    gen = _port_gen(model)
    free0 = _free(gen)
    server = WebSocketServer(gen)
    short = 12
    text_c = _alone(_port_gen(model), PROMPTS[2], short)

    async def run():
        c1, c2 = Conn(), Conn()
        tasks = [asyncio.create_task(server.dispatch(
                     _infer(PROMPTS[0], 400, rid="a"), c1)),
                 asyncio.create_task(server.dispatch(
                     _infer(PROMPTS[1], 400, rid="b"), c1)),
                 asyncio.create_task(server.dispatch(
                     _infer(PROMPTS[2], short, rid="c"), c2))]
        await _wait_chunk(c1, "a")
        await _wait_chunk(c1, "b")
        await server.dispatch({"action": "stop"}, c1)
        await asyncio.gather(*tasks)
        return c1.sent, c2.sent

    s1, s2 = asyncio.run(run())
    for rid in ("a", "b"):
        joined, full = _by_request(s1, rid)
        assert joined == full and len(full) < 400
    assert _by_request(s2, "c") == (text_c, text_c)
    assert gen.num_remaining_jobs() == 0 and _free(gen) == free0


def test_websocket_round_trip(model):
    websockets = pytest.importorskip("websockets")
    gen = _port_gen(model)
    server = WebSocketServer(gen, ip="127.0.0.1", port=0)
    text = _alone(_port_gen(model), PROMPTS[0], 10)

    async def run():
        async with websockets.serve(server.handler, "127.0.0.1", 0) as srv:
            port = srv.sockets[0].getsockname()[1]
            async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
                await ws.send(json.dumps({"action": "estimate_token",
                                          "text": "hello"}))
                est = json.loads(await ws.recv())
                await ws.send("not json")
                bad = json.loads(await ws.recv())
                # an infer, and on the same connection a second one that a
                # stop ends while the first streams
                await ws.send(json.dumps(_infer(PROMPTS[0], 10, rid=1)))
                await ws.send(json.dumps(_infer(PROMPTS[1], 400, rid=2)))
                sent = []
                stopped = False
                while sum(m.get("response_type") == "full"
                          for m in sent) < 2:
                    sent.append(json.loads(await ws.recv()))
                    if not stopped and sent[-1].get("request_id") == 2:
                        await ws.send(json.dumps({"action": "stop",
                                                  "request_id": 2}))
                        stopped = True
                return est, bad, sent

    est, bad, sent = asyncio.run(run())
    assert est == {"action": "estimate_token", "num_tokens": 5}
    assert bad == {"error": "bad json"}
    assert _by_request(sent, 1) == (text, text)
    joined, full = _by_request(sent, 2)
    assert joined == full and len(full) < 400
    assert gen.num_remaining_jobs() == 0


def test_many_requests_under_thread_switches(model):
    """Twelve requests on four connections, the interpreter switching
    threads every microsecond, and a stop among them: every finished request
    gets its prompt's own text, the stopped one ends, no page is lost."""
    import sys
    gen = _port_gen(model)
    free0 = _free(gen)
    server = WebSocketServer(gen)
    prompts = [PROMPTS[i % 3] + " " * (i // 3) for i in range(12)]
    texts = {p: _alone(_port_gen(model), p, 6) for p in set(prompts)}

    async def run():
        conns = [Conn() for _ in range(4)]
        tasks = [asyncio.create_task(server.dispatch(
            _infer(p, 6 if i else 400, rid=i), conns[i % 4]))
            for i, p in enumerate(prompts)]
        await _wait_chunk(conns[0], 0)
        await server.dispatch({"action": "stop", "request_id": 0}, conns[0])
        await asyncio.wait_for(asyncio.gather(*tasks), 120)
        return conns

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        conns = asyncio.run(run())
    finally:
        sys.setswitchinterval(interval)
    for i, p in enumerate(prompts):
        joined, full = _by_request(conns[i % 4].sent, i)
        assert joined == full
        if i:
            assert full == texts[p], i
        else:
            assert len(full) < 400
    assert gen.num_remaining_jobs() == 0 and _free(gen) == free0
