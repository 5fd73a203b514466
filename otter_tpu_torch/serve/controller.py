# A copy of otter_tpu/serve/controller.py (the port imports nothing of the JAX package);
# tests/test_torch_serve.py holds its output equal to the original's.
"""Serving controller: worker registry, heartbeat expiry, dispatch.

Same HTTP API as the reference controller (`pipeline/serve/controller.py`
routes :240-283: /register_worker /refresh_all_workers /list_models
/get_worker_address /receive_heart_beat /worker_generate_stream
/worker_get_status), implemented on aiohttp (FastAPI is not available in
this image). Dispatch: lottery (speed-weighted) or shortest_queue
(`get_worker_address`, controller.py:120-169); stale workers expire after
CONTROLLER_HEART_BEAT_EXPIRATION (controller.py:181-189).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import threading
import time
from enum import Enum, auto
from typing import Dict, List, Optional

import numpy as np

CONTROLLER_HEART_BEAT_EXPIRATION = 90
SERVER_ERROR_MSG = ("**NETWORK ERROR DUE TO HIGH TRAFFIC. PLEASE REGENERATE "
                    "OR REFRESH THIS PAGE.**")


class DispatchMethod(Enum):
    LOTTERY = auto()
    SHORTEST_QUEUE = auto()

    @classmethod
    def from_str(cls, name: str) -> "DispatchMethod":
        return {"lottery": cls.LOTTERY,
                "shortest_queue": cls.SHORTEST_QUEUE}[name]


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue",
                 *, status_fetcher=None):
        self.worker_info: Dict[str, WorkerInfo] = {}
        self.dispatch_method = DispatchMethod.from_str(dispatch_method)
        # injectable for tests; default POSTs the worker's status route
        self._fetch_status = status_fetcher or self._http_fetch_status
        self._lock = threading.Lock()

    @staticmethod
    def _http_fetch_status(worker_name: str) -> Optional[dict]:
        import requests
        try:
            r = requests.post(worker_name + "/worker_get_status", timeout=25)
        except Exception:
            return None
        return r.json() if r.status_code == 200 else None

    def register_worker(self, worker_name: str, check_heart_beat: bool,
                        worker_status: Optional[dict]) -> bool:
        if not worker_status:
            worker_status = self._fetch_status(worker_name)
        if not worker_status:
            return False
        with self._lock:
            self.worker_info[worker_name] = WorkerInfo(
                worker_status["model_names"], worker_status["speed"],
                worker_status["queue_length"], check_heart_beat, time.time())
        return True

    def remove_worker(self, worker_name: str):
        with self._lock:
            self.worker_info.pop(worker_name, None)

    def refresh_all_workers(self):
        old = dict(self.worker_info)
        self.worker_info = {}
        for name, info in old.items():
            self.register_worker(name, info.check_heart_beat, None)

    def list_models(self) -> List[str]:
        names = set()
        for info in self.worker_info.values():
            names.update(info.model_names)
        return list(names)

    def get_worker_address(self, model_name: str) -> str:
        with self._lock:
            candidates = [(n, i) for n, i in self.worker_info.items()
                          if model_name in i.model_names]
        if not candidates:
            return ""
        if self.dispatch_method == DispatchMethod.LOTTERY:
            speeds = np.array([i.speed for _, i in candidates], np.float32)
            norm = speeds.sum()
            if norm < 1e-4:
                return ""
            idx = np.random.choice(len(candidates), p=speeds / norm)
            return candidates[idx][0]
        # shortest queue (normalized by speed)
        qlens = [i.queue_length / i.speed for _, i in candidates]
        name = candidates[int(np.argmin(qlens))][0]
        with self._lock:
            self.worker_info[name].queue_length += 1
        return name

    def receive_heart_beat(self, worker_name: str, queue_length: int) -> bool:
        with self._lock:
            if worker_name not in self.worker_info:
                return False
            self.worker_info[worker_name].queue_length = queue_length
            self.worker_info[worker_name].last_heart_beat = time.time()
        return True

    def remove_stale_workers_by_expiration(self):
        expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        stale = [n for n, i in self.worker_info.items()
                 if i.check_heart_beat and i.last_heart_beat < expire]
        for n in stale:
            self.remove_worker(n)

    def worker_api_get_status(self) -> dict:
        """Controller-as-worker aggregation (controller.py:219-238)."""
        names, speed, qlen = set(), 0, 0
        for n in list(self.worker_info):
            st = self._fetch_status(n)
            if st:
                names.update(st["model_names"])
                speed += st["speed"]
                qlen += st["queue_length"]
        return {"model_names": list(names), "speed": speed,
                "queue_length": qlen}


def build_app(controller: Controller):
    """aiohttp application exposing the reference's routes."""
    from aiohttp import web

    async def register_worker(request):
        d = await request.json()
        ok = controller.register_worker(
            d["worker_name"], d["check_heart_beat"],
            d.get("worker_status"))
        return web.json_response({"exist": ok})

    async def refresh_all_workers(request):
        controller.refresh_all_workers()
        return web.json_response({})

    async def list_models(request):
        return web.json_response({"models": controller.list_models()})

    async def get_worker_address(request):
        d = await request.json()
        return web.json_response(
            {"address": controller.get_worker_address(d["model"])})

    async def receive_heart_beat(request):
        d = await request.json()
        exist = controller.receive_heart_beat(d["worker_name"],
                                              d["queue_length"])
        return web.json_response({"exist": exist})

    async def worker_generate_stream(request):
        """Proxy streaming to the dispatched worker
        (controller.py:192-217)."""
        import requests
        params = await request.json()
        resp = web.StreamResponse()
        await resp.prepare(request)
        addr = controller.get_worker_address(params["model"])
        if not addr:
            await resp.write(json.dumps(
                {"text": SERVER_ERROR_MSG, "error_code": 2}).encode() + b"\0")
            return resp
        try:
            r = requests.post(addr + "/worker_generate_stream", json=params,
                              stream=True, timeout=25)
            for chunk in r.iter_lines(decode_unicode=False, delimiter=b"\0"):
                if chunk:
                    await resp.write(chunk + b"\0")
        except Exception:
            await resp.write(json.dumps(
                {"text": SERVER_ERROR_MSG, "error_code": 3}).encode() + b"\0")
        return resp

    async def worker_get_status(request):
        return web.json_response(controller.worker_api_get_status())

    app = web.Application()
    app.router.add_post("/register_worker", register_worker)
    app.router.add_post("/refresh_all_workers", refresh_all_workers)
    app.router.add_post("/list_models", list_models)
    app.router.add_post("/get_worker_address", get_worker_address)
    app.router.add_post("/receive_heart_beat", receive_heart_beat)
    app.router.add_post("/worker_generate_stream", worker_generate_stream)
    app.router.add_post("/worker_get_status", worker_get_status)
    return app


def main():
    import argparse
    from aiohttp import web
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=21001)
    p.add_argument("--dispatch-method", default="shortest_queue",
                   choices=["lottery", "shortest_queue"])
    args = p.parse_args()
    controller = Controller(args.dispatch_method)

    def expire_loop():
        while True:
            time.sleep(CONTROLLER_HEART_BEAT_EXPIRATION)
            controller.remove_stale_workers_by_expiration()

    threading.Thread(target=expire_loop, daemon=True).start()
    web.run_app(build_app(controller), host=args.host, port=args.port)


if __name__ == "__main__":
    main()
