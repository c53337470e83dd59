"""Asyncio wrapper over the dynamic generator.

Analog of exllamav2/generator/dynamic_async.py: a background task pumps
iterate() while jobs stream results through per-job asyncio queues;
DynamicJobAsync is an async iterator.
"""

from __future__ import annotations

import asyncio

from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator, DynamicJob

__all__ = ["DynamicGeneratorAsync", "DynamicJobAsync"]


class DynamicGeneratorAsync:
    def __init__(self, generator: DynamicGenerator):
        self.generator = generator
        self.jobs: dict[int, "DynamicJobAsync"] = {}
        self.condition = asyncio.Condition()
        self.iteration_task = asyncio.create_task(self._run())

    async def _run(self):
        try:
            while True:
                async with self.condition:
                    await self.condition.wait_for(lambda: bool(self.jobs))
                results = await asyncio.to_thread(self.generator.iterate)
                for r in results:
                    serial = r.get("serial")
                    aj = self.jobs.get(serial)
                    if aj is not None:
                        await aj.queue.put(r)
                        if r.get("eos"):
                            del self.jobs[serial]
                if not results:
                    await asyncio.sleep(0)
        except asyncio.CancelledError:
            pass
        except Exception as e:
            for aj in self.jobs.values():
                await aj.queue.put(e)

    async def enqueue(self, job: "DynamicJobAsync"):
        async with self.condition:
            self.generator.enqueue(job.job)
            self.jobs[id(job.job)] = job
            self.condition.notify_all()

    async def close(self):
        self.iteration_task.cancel()
        try:
            await self.iteration_task
        except asyncio.CancelledError:
            pass


class DynamicJobAsync:
    def __init__(self, generator: DynamicGeneratorAsync, *args, **kwargs):
        self.job = DynamicJob(*args, **kwargs)
        self.queue: asyncio.Queue = asyncio.Queue()
        self.generator = generator

    def __aiter__(self):
        return self

    async def __anext__(self):
        if getattr(self, "_finished", False):
            raise StopAsyncIteration
        r = await self.queue.get()
        if isinstance(r, Exception):
            raise r
        if r.get("eos"):
            self._finished = True
        return r
