"""ASGI app embedding for Serve deployments (+ websocket sessions).

reference: python/ray/serve/api.py:174 (@serve.ingress mounts an existing
FastAPI/ASGI app behind a deployment) and serve/_private/http_util.py:335-351
(websocket proxying).  Here any ASGI callable — FastAPI/Starlette if the
user ships one, or a plain ``async def app(scope, receive, send)`` —
runs INSIDE the replica; the ingress proxy forwards the raw request
(method/path/headers/body) instead of a JSON payload, and the app owns its
own routing.

Websockets: the proxy performs the RFC6455 upgrade and bridges frames to a
per-connection ASGI websocket session living in the replica.  The session's
coroutine is pumped between handle calls (parked awaiting ``receive``);
server pushes between client frames flush on the next event — request/
response and echo/chat patterns are exact, unsolicited push is batched.
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


def ingress(app):
    """Class decorator mounting an ASGI callable behind a deployment.

    Usage (reference api.py:174 shape)::

        @serve.deployment
        @serve.ingress(asgi_app)
        class MyApp:
            ...

    The wrapped class keeps its own __init__; requests reach the ASGI app,
    not the class's __call__.
    """

    def wrap(cls):
        class ASGIIngress(cls):
            _IS_ASGI = True

            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self._asgi_driver = ASGIDriver(app)

            def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
                return self._asgi_driver.handle(request)

        ASGIIngress.__name__ = cls.__name__
        ASGIIngress.__qualname__ = cls.__qualname__
        return ASGIIngress

    return wrap


def build_asgi_deployment(app, name: str = "asgi_app"):
    """Functional form: a ready Deployment hosting a bare ASGI callable."""
    from ray_tpu_torch.serve.api import deployment

    @ingress(app)
    class _App:
        pass

    _App.__name__ = name
    return deployment(_App)


class ASGIDriver:
    """Runs an ASGI app on a private event loop inside the replica."""

    def __init__(self, app):
        self._app = app
        self._loop = asyncio.new_event_loop()
        self._lock = threading.Lock()
        self._ws: Dict[str, _WsSession] = {}

    # -- dispatch --------------------------------------------------------

    def handle(self, request: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            ws = request.get("__ws__")
            if ws == "connect":
                return self._ws_connect(request)
            if ws == "message":
                return self._ws_message(request)
            if ws == "disconnect":
                return self._ws_disconnect(request)
            return self._http(request)

    # -- plain http ------------------------------------------------------

    def _http(self, request: Dict[str, Any]) -> Dict[str, Any]:
        body = request.get("body") or b""
        scope = _scope("http", request)
        received = {"sent": False}
        out = {"status": 500, "headers": [], "body": b""}

        async def receive():
            if not received["sent"]:
                received["sent"] = True
                return {"type": "http.request", "body": body,
                        "more_body": False}
            return {"type": "http.disconnect"}

        async def send(message):
            if message["type"] == "http.response.start":
                out["status"] = message["status"]
                out["headers"] = [
                    (bytes(k).decode("latin1"), bytes(v).decode("latin1"))
                    for k, v in message.get("headers", [])]
            elif message["type"] == "http.response.body":
                out["body"] += bytes(message.get("body", b""))

        self._loop.run_until_complete(self._app(scope, receive, send))
        return out

    # -- websocket sessions ---------------------------------------------

    def _ws_connect(self, request) -> Dict[str, Any]:
        cid = request["id"]
        scope = _scope("websocket", request)
        session = _WsSession(self._loop, self._app, scope)
        self._ws[cid] = session
        session.feed({"type": "websocket.connect"})
        sends = self._pump(session)
        accepted = any(m["type"] == "websocket.accept" for m in sends)
        closed = any(m["type"] == "websocket.close" for m in sends)
        if not accepted or closed:
            # the app coroutine may still be parked on receive(): cancel it
            # or every rejected connect leaks a task on the replica loop
            self._ws.pop(cid, None)
            self._reap(session)
        return {"accepted": accepted and not closed,
                "messages": _outbound(sends)}

    def _ws_message(self, request) -> Dict[str, Any]:
        session = self._ws.get(request["id"])
        if session is None:
            return {"closed": True, "messages": []}
        event: Dict[str, Any] = {"type": "websocket.receive"}
        if request.get("text") is not None:
            event["text"] = request["text"]
        else:
            event["bytes"] = request.get("bytes", b"")
        session.feed(event)
        sends = self._pump(session)
        closed = (session.task.done()
                  or any(m["type"] == "websocket.close" for m in sends))
        if closed:
            self._ws.pop(request["id"], None)
        return {"closed": closed, "messages": _outbound(sends)}

    def _ws_disconnect(self, request) -> Dict[str, Any]:
        session = self._ws.pop(request["id"], None)
        if session is not None:
            session.feed({"type": "websocket.disconnect", "code": 1000})
            self._pump(session)
            self._reap(session)
        return {"closed": True, "messages": []}

    def _reap(self, session: "_WsSession"):
        """Cancel + drain a session's app coroutine (no task may outlive
        its connection on the replica loop)."""
        session.task.cancel()
        try:
            self._loop.run_until_complete(
                asyncio.gather(session.task, return_exceptions=True))
        except Exception:  # noqa: BLE001 — reap drains a cancelled task; errors are expected
            pass

    #: apps may legitimately await things other than receive() between
    #: frames (outbound I/O, short timers) — those awaits complete under
    #: asyncio.wait below.  An app still un-parked after this long is cut
    #: off for this pump with a warning (its later sends surface on the
    #: next inbound event).
    _PUMP_TIMEOUT_S = float(os.environ.get("RAY_TPU_ASGI_PUMP_TIMEOUT_S", "5"))

    def _pump(self, session: "_WsSession") -> List[dict]:
        """Run the loop until the app parks on receive() (or finishes);
        returns and clears the send events produced meanwhile."""

        async def until_parked():
            deadline = self._loop.time() + self._PUMP_TIMEOUT_S
            while not session.task.done():
                if session.parked.is_set() and session.inbox.empty():
                    break
                remaining = deadline - self._loop.time()
                if remaining <= 0:
                    logger.warning(
                        "ASGI websocket app did not park on receive() "
                        "within %.1fs (awaiting something else?); replies "
                        "produced later will be delivered on the next "
                        "inbound event", self._PUMP_TIMEOUT_S)
                    break
                waiter = asyncio.ensure_future(session.parked.wait())
                try:
                    await asyncio.wait({session.task, waiter},
                                       timeout=remaining,
                                       return_when=asyncio.FIRST_COMPLETED)
                finally:
                    waiter.cancel()

        self._loop.run_until_complete(until_parked())
        sends, session.sends = session.sends, []
        return sends


class _WsSession:
    def __init__(self, loop, app, scope):
        self.loop = loop
        self.inbox: asyncio.Queue = asyncio.Queue()
        self.sends: List[dict] = []
        # asyncio.Event so _pump can await parking instead of spinning
        self.parked = asyncio.Event()
        session = self

        async def receive():
            if session.inbox.empty():
                session.parked.set()
            msg = await session.inbox.get()
            session.parked.clear()
            return msg

        async def send(message):
            session.sends.append(message)

        self.task = loop.create_task(app(scope, receive, send))

    def feed(self, event: dict):
        self.inbox.put_nowait(event)
        self.parked.clear()


def _scope(kind: str, request: Dict[str, Any]) -> Dict[str, Any]:
    path = request.get("path", "/")
    return {
        "type": kind,
        "asgi": {"version": "3.0", "spec_version": "2.3"},
        "http_version": "1.1",
        "method": request.get("method", "GET"),
        "scheme": "http" if kind == "http" else "ws",
        "path": path,
        "raw_path": path.encode(),
        "root_path": request.get("root_path", ""),
        "query_string": (request.get("query") or "").encode(),
        "headers": [(k.lower().encode("latin1"), v.encode("latin1"))
                    for k, v in (request.get("headers") or {}).items()],
        "client": ("127.0.0.1", 0),
        "server": ("127.0.0.1", 0),
        "subprotocols": [],
    }


def _outbound(sends: List[dict]) -> List[dict]:
    """websocket.send events -> wire-able {text|bytes} messages."""
    out = []
    for m in sends:
        if m["type"] != "websocket.send":
            continue
        if m.get("text") is not None:
            out.append({"text": m["text"]})
        elif m.get("bytes") is not None:
            out.append({"bytes": bytes(m["bytes"])})
    return out
