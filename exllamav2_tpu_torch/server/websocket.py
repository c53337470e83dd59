"""JSON-over-websocket inference server (PyTorch port of
exllamav2_tpu/server/websocket.py).

Analog of ExLlamaV2WebSocketServer (exllamav2/server/websocket*.py): a small
action-dispatch protocol -- echo / estimate_token / lefttrim_token / infer /
stop -- streaming generated chunks as they arrive, with the reference's
messages and fields.

Unlike the reference, requests in flight share the generator correctly:
- one pump task per server calls ``generator.iterate()`` (in a worker
  thread, under one lock, one call at a time) and routes every result by
  its ``serial`` to the queue of the request that owns the job; the
  reference pumps in each request's own loop and drops the results of
  every other request's job, so two concurrent requests swallow each
  other's chunks (and two threads may run ``iterate`` at once);
- ``stop`` ends the jobs of the connection that sends it, or with a
  ``request_id`` that request's jobs only, through the generator's own
  ``cancel`` (their pages return to the pool); the reference sets one flag
  that ends every request's stream and leaves the jobs running;
- a connection's ``infer`` requests run beside its later messages, so a
  ``stop`` on the same connection reaches them.

``websockets`` is imported only by ``serve_forever`` / ``main``;
``dispatch(request, connection)`` works with any object that has an async
``send(str)``.
"""

from __future__ import annotations

import asyncio
import json
import threading

from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator, DynamicJob
from exllamav2_tpu_torch.generator.sampler import Settings

__all__ = ["WebSocketServer"]

_IDS = ("request_id", "response_id")


class WebSocketServer:
    def __init__(self, generator: DynamicGenerator, ip: str = "0.0.0.0",
                 port: int = 7862):
        self.generator = generator
        self.tokenizer = generator.tokenizer
        self.ip = ip
        self.port = port
        self._lock = threading.Lock()     # held around every generator call
        self._incoming: list[DynamicJob] = []
        self._stopping: list[DynamicJob] = []
        # serial -> (queue, connection, request_id, job) of a live request
        self._routes: dict[int, tuple] = {}
        self._pump_task: asyncio.Task | None = None
        self._wake: asyncio.Event | None = None

    def serve_forever(self):
        asyncio.run(self.main())

    async def main(self):
        try:
            import websockets
        except ImportError as e:
            raise ImportError(
                "WebSocketServer.serve_forever needs the `websockets` "
                "package; without it, drive dispatch(request, connection) "
                "in process with any object that has an async send") from e
        async with websockets.serve(self.handler, self.ip, self.port):
            await asyncio.Future()

    async def handler(self, ws):
        tasks: set[asyncio.Task] = set()
        try:
            async for message in ws:
                try:
                    request = json.loads(message)
                except json.JSONDecodeError:
                    await ws.send(json.dumps({"error": "bad json"}))
                    continue
                if request.get("action") == "infer":
                    # streams until its job ends: run it beside the
                    # connection's later messages (a stop among them)
                    t = asyncio.create_task(self.dispatch(request, ws))
                    tasks.add(t)
                    t.add_done_callback(tasks.discard)
                else:
                    await self.dispatch(request, ws)
        finally:
            self.stop(ws)                 # a closed connection's jobs end
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)

    async def dispatch(self, request: dict, ws):
        action = request.get("action")
        response = {"action": action}
        for k in _IDS:
            if k in request:
                response[k] = request[k]

        if action == "echo":
            pass
        elif action == "estimate_token":
            ids = self.tokenizer.encode(request["text"])
            response["num_tokens"] = int(len(ids))
        elif action == "lefttrim_token":
            ids = self.tokenizer.encode(request["text"])
            limit = int(request["max_tokens"])
            response["trimmed_text"] = self.tokenizer.decode(ids[-limit:])
        elif action == "infer":
            await self.infer(request, ws, response)
            return
        elif action == "stop":
            self.stop(ws, request.get("request_id"))
        else:
            response["error"] = f"unknown action {action!r}"
        await ws.send(json.dumps(response))

    def stop(self, ws, request_id=None) -> int:
        """End the live jobs of connection `ws` (of its request `request_id`
        only, when given) -> how many were asked to end. The pump cancels
        them before its next step."""
        jobs = [job for _, conn, rid, job in self._routes.values()
                if conn is ws and (request_id is None or rid == request_id)]
        if jobs:
            self._stopping += jobs
            self._kick()
        return len(jobs)

    async def infer(self, request: dict, ws, response: dict):
        s = Settings()
        for key, attr in (("temperature", "temperature"),
                          ("top_k", "top_k"), ("top_p", "top_p"),
                          ("min_p", "min_p"),
                          ("rep_pen", "token_repetition_penalty")):
            if key in request:
                setattr(s, attr, request[key])
        ids = self.tokenizer.encode(request["text"],
                                    add_bos=request.get("add_bos", False))
        stop_conditions = request.get("stop_conditions", [])
        job = DynamicJob(ids, max_new_tokens=int(
            request.get("max_new_tokens", 256)), settings=s,
            stop_conditions=stop_conditions)
        queue: asyncio.Queue = asyncio.Queue()
        self._routes[id(job)] = (queue, ws, request.get("request_id"), job)
        self._incoming.append(job)
        self._kick()

        ids_in = {k: response[k] for k in _IDS if k in response}
        full = ""
        try:
            while True:
                r = await queue.get()
                if r is None:                     # stopped
                    break
                if isinstance(r, BaseException):
                    raise r
                if r["stage"] != "streaming":
                    continue
                chunk = r.get("text", "")
                full += chunk
                if chunk and request.get("stream", True):
                    await ws.send(json.dumps({
                        "action": "infer", "response_type": "chunk",
                        "chunk": chunk, **ids_in}))
                if r["eos"]:
                    break
        finally:
            if job.status != "done":          # the caller went away
                self._stopping.append(job)
                self._kick()
            self._routes.pop(id(job), None)
        response["response_type"] = "full"
        response["util_text"] = ""
        response["response"] = full
        await ws.send(json.dumps(response))

    # ------------------------------------------------------------------
    # the pump
    # ------------------------------------------------------------------

    def _kick(self):
        """Wake the pump, starting it in the running loop if it is not
        running there."""
        loop = asyncio.get_running_loop()
        task = self._pump_task
        if task is None or task.done() or task.get_loop() is not loop:
            if task is not None and task.done() and not task.cancelled():
                task.exception()      # already routed to its requests
            self._wake = asyncio.Event()
            self._pump_task = loop.create_task(self._pump())
        self._wake.set()

    def _route(self, serial, item):
        entry = self._routes.get(serial)
        if entry is not None:
            entry[0].put_nowait(item)

    def _admit(self):
        """Enqueue the new jobs and cancel the stopped ones, under the lock
        (no iterate runs: only the pump calls it, and it is here)."""
        incoming, self._incoming = self._incoming, []
        stopping, self._stopping = self._stopping, []
        with self._lock:
            for job in incoming:
                try:
                    self.generator.enqueue(job)
                except (ValueError, AssertionError) as e:
                    # longer than max_seq_len or the pool: this request fails
                    job.status = "done"
                    self._route(id(job), e)
            for job in stopping:
                self.generator.cancel(job)
                self._route(id(job), None)

    def _iterate(self) -> list[dict]:
        with self._lock:
            return self.generator.iterate()

    async def _pump(self):
        try:
            while True:
                self._admit()
                if not self.generator.num_remaining_jobs():
                    if self._incoming or self._stopping:
                        continue
                    self._wake.clear()
                    await self._wake.wait()
                    continue
                for r in await asyncio.to_thread(self._iterate):
                    self._route(r.get("serial"), r)
        except Exception as e:
            # fail every waiting request rather than leave it hanging
            for serial in list(self._routes):
                self._route(serial, e)
            raise
