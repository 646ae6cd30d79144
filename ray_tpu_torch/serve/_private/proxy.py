"""HTTP proxy: asyncio ingress routing requests to deployment handles.

reference: python/ray/serve/_private/proxy.py (ProxyActor :1020, HTTPProxy
:706) — the reference fronts deployments with a uvicorn ASGI server
(http_util.py:23-31). TPU-native rebuild (round 2, replacing the stdlib
ThreadingHTTPServer): a single asyncio event loop owns every connection
(keep-alive, concurrent SSE streams), while blocking handle calls run on a
bounded thread pool — overload queues work instead of erroring, and one
stalled stream never starves other connections.

The module-level surface (start_proxy/stop_proxy/register_route/
unregister_route/match_route/list_routes) is shared with the gRPC-style RPC
ingress and the local testing mode.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)

_MAX_BODY = 64 * 1024 * 1024
_HANDLE_TIMEOUT_S = 60.0


class _ProxyState:
    def __init__(self):
        self.routes: Dict[str, object] = {}  # route_prefix -> DeploymentHandle
        self.asgi: Dict[str, bool] = {}      # route_prefix -> mounts ASGI app
        self.lock = threading.Lock()


_state = _ProxyState()
_proxy: Optional["_AsyncProxy"] = None


def match_route(path: str):
    """Longest-prefix route match, shared by every ingress (HTTP + RPC)."""
    return (match_route_full(path) or (None,) * 3)[0]


def match_route_full(path: str):
    """(handle, route_prefix, is_asgi) or None."""
    with _state.lock:
        routes = dict(_state.routes)
        asgi = dict(_state.asgi)
    for prefix, handle in sorted(routes.items(), key=lambda kv: -len(kv[0])):
        if path == prefix or path.startswith(prefix.rstrip("/") + "/") or prefix == "/":
            return handle, prefix, asgi.get(prefix, False)
    return None


def list_routes():
    with _state.lock:
        return sorted(_state.routes)


class _BadRequest(Exception):
    pass


class _AsyncProxy:
    """One event loop + bounded executor serving all proxy connections."""

    def __init__(self, host: str, port: int, max_handle_threads: int = 64):
        from ray_tpu_torch._private.config import global_config
        from ray_tpu_torch.serve._private import admission

        self._host = host
        self._port = port
        self._loop = asyncio.new_event_loop()
        self._pool = ThreadPoolExecutor(
            max_workers=max_handle_threads, thread_name_prefix="proxy-handle"
        )
        # weighted-fair admitted-work scheduler over the pool: beyond
        # max_handle_threads running calls, work queues in WFQ order up to
        # a bounded backlog, past which submit raises Saturated -> 503 +
        # Retry-After (never the old unbounded executor queue)
        cfg = global_config()
        self._fair = admission.FairExecutor(
            self._pool, max_running=max_handle_threads,
            backlog=int(cfg.serve_admission_backlog),
            weights=admission.parse_weights(cfg.serve_admission_weights),
            retry_after_s=float(cfg.serve_admission_retry_after_s))
        self._server: Optional[asyncio.base_events.Server] = None
        self._boot_error: Optional[BaseException] = None
        started = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(started,), daemon=True, name="serve-http-proxy"
        )
        self._thread.start()
        started.wait(timeout=10)
        if self._server is None:
            err = self._boot_error
            raise RuntimeError(f"proxy failed to start: {err}") from err
        self.address: Tuple[str, int] = self._server.sockets[0].getsockname()[:2]

    def _run(self, started: threading.Event):
        asyncio.set_event_loop(self._loop)

        async def boot():
            try:
                self._server = await asyncio.start_server(
                    self._handle_conn, self._host, self._port
                )
            except BaseException as e:  # noqa: BLE001
                self._boot_error = e
            finally:
                started.set()

        self._loop.run_until_complete(boot())
        if self._boot_error is not None:
            return
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    def stop(self):
        def _shutdown():
            if self._server is not None:
                self._server.close()
            self._loop.stop()

        try:
            self._loop.call_soon_threadsafe(_shutdown)
            self._thread.join(timeout=5)
        except RuntimeError:
            pass
        self._pool.shutdown(wait=False, cancel_futures=True)

    # -- HTTP/1.1 ----------------------------------------------------------

    async def _read_request(self, reader):
        line = await reader.readline()
        if not line or line in (b"\r\n", b"\n"):
            return None
        try:
            method, target, _version = line.decode("latin1").split(" ", 2)
        except ValueError:
            raise _BadRequest("malformed request line")
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            if b":" in h:
                k, v = h.split(b":", 1)
                headers[k.decode("latin1").strip().lower()] = v.decode("latin1").strip()
        if "chunked" in headers.get("transfer-encoding", "").lower():
            # decode the chunk stream in full — leaving it unread would make
            # the keep-alive loop re-parse raw chunks as the next request and
            # corrupt connection framing
            body = await self._read_chunked(reader)
            return method, target, headers, body
        try:
            length = int(headers.get("content-length", 0) or 0)
        except ValueError:
            raise _BadRequest("bad content-length")
        if length > _MAX_BODY:
            raise _BadRequest("body too large")
        body = await reader.readexactly(length) if length else b""
        return method, target, headers, body

    @staticmethod
    async def _read_chunked(reader) -> bytes:
        chunks = []
        total = 0
        while True:
            size_line = await reader.readline()
            if not size_line:
                # EOF mid-stream is a truncated body, not a terminating chunk
                raise asyncio.IncompleteReadError(partial=b"".join(chunks), expected=None)
            try:
                size = int(size_line.split(b";", 1)[0].strip(), 16)
            except ValueError:
                raise _BadRequest("bad chunk size")
            if size == 0:
                # consume the trailer section up to its terminating blank line
                while True:
                    t = await reader.readline()
                    if t in (b"\r\n", b"\n", b""):
                        break
                return b"".join(chunks)
            total += size
            if total > _MAX_BODY:
                raise _BadRequest("body too large")
            chunks.append(await reader.readexactly(size))
            await reader.readexactly(2)  # trailing CRLF

    @staticmethod
    def _response(status: int, body: bytes, content_type: str = "application/json",
                  keep_alive: bool = True, extra_headers=None) -> bytes:
        reason = {200: "OK", 404: "Not Found", 400: "Bad Request",
                  429: "Too Many Requests", 503: "Service Unavailable",
                  500: "Internal Server Error"}.get(status, "OK")
        conn = "keep-alive" if keep_alive else "close"
        extras = "".join(f"{k}: {v}\r\n" for k, v in (extra_headers or ()))
        return (
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"{extras}"
            f"Connection: {conn}\r\n\r\n"
        ).encode("latin1") + body

    async def _handle_conn(self, reader, writer):
        try:
            while True:
                try:
                    req = await self._read_request(reader)
                except (_BadRequest, asyncio.IncompleteReadError, ValueError):
                    # ValueError: oversized header line (StreamReader limit)
                    writer.write(self._response(400, b'{"error": "bad request"}',
                                                keep_alive=False))
                    await writer.drain()
                    break
                if req is None:
                    break
                method, target, headers, body = req
                if headers.get("upgrade", "").lower() == "websocket":
                    await self._handle_websocket(
                        reader, writer, method, target, headers)
                    break  # ws owns the connection until close
                keep = await self._dispatch(writer, method, target, headers,
                                            body)
                if not keep:
                    break
        except (ConnectionResetError, BrokenPipeError, asyncio.CancelledError):
            pass
        except Exception:  # noqa: BLE001
            logger.exception("proxy connection handler failed")
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001 — client socket already gone
                pass

    @staticmethod
    def _deployment_of(handle) -> str:
        # DeploymentHandle carries _dep; LocalDeploymentHandle carries _name
        return (getattr(handle, "_dep", None)
                or getattr(handle, "_name", None) or "app")

    async def _dispatch(self, writer, method: str, target: str,
                        headers: Dict[str, str], body: bytes) -> bool:
        from ray_tpu_torch.serve._private import admission, slo
        from ray_tpu_torch.util import tracing

        path = target.split("?")[0]
        matched = match_route_full(path)
        if matched is None:
            writer.write(self._response(404, b'{"error": "no route"}'))
            await writer.drain()
            return True
        handle, prefix, is_asgi = matched
        # W3C trace context: continue the caller's trace (or root a new
        # one) so the handle call — and everything it causes: replica,
        # engine steps, collectives — lands in one distributed trace.
        # The request span's id goes back out as a traceparent header.
        # Per-request rooting is deliberate: the request IS the trace
        # unit, and its span volume is the same order as the lifecycle
        # events its actor task already feeds the bounded sink; durable
        # aggregates live in the metrics plane, the sink is recent-window
        # by design.  Disable via tracing_enabled=False.
        ctx3 = tracing.ingest(headers.get("traceparent"))
        trace_headers = ([("traceparent",
                           tracing.format_traceparent(ctx3[0], ctx3[1]))]
                         if ctx3 else None)
        if is_asgi:
            return await self._dispatch_asgi(
                writer, handle, prefix, method, target, headers, body,
                ctx3=ctx3, trace_headers=trace_headers)
        try:
            payload = json.loads(body) if body else None
        except json.JSONDecodeError:
            payload = body.decode() if body else None

        # request-level SLO lifecycle (serve/_private/slo.py): every
        # ingress request gets a tracker carrying the tenant id (x-tenant
        # header / request-dict field / default); the NOOP tracker makes
        # the disabled path one empty call per hook
        deployment = self._deployment_of(handle)
        tenant = slo.extract_tenant(headers=headers, payload=payload)
        tracker = slo.start_request(
            deployment, tenant=tenant,
            trace_id=ctx3[0] if ctx3 else None)

        # tenant-fair admission gate (serve/_private/admission.py): a
        # refusal is a terminal `shed` on the tracker plus 429/503 +
        # Retry-After to the client — BEFORE any queueing.  Disabled ->
        # gate is None and this is one None check
        gate = admission.get_controller()
        if gate is not None:
            verdict = gate.decide(tenant, deployment)
            if not verdict.admitted:
                tracker.shed()
                await self._refuse(writer, verdict.status, verdict.decision,
                                   verdict.retry_after_s, trace_headers)
                return True

        if isinstance(payload, dict) and payload.get("stream"):
            try:
                await self._dispatch_stream(writer, handle, payload,
                                            ctx3=ctx3,
                                            trace_headers=trace_headers,
                                            tracker=tracker)
            finally:
                if gate is not None:
                    gate.release(tenant)
            return False  # SSE ends with connection close (no chunked TE)

        t_queued = time.perf_counter()

        def call():
            slo.record_stage(tracker.deployment or None, "proxy_queue",
                             time.perf_counter() - t_queued)
            with slo.activate(tracker), tracing.activate_span(
                    ctx3, f"HTTP {method} {path}", kind="server",
                    attributes={"http.method": method, "http.path": path}):
                if payload is None:
                    return handle.remote().result(timeout_s=_HANDLE_TIMEOUT_S)
                return handle.remote(payload).result(timeout_s=_HANDLE_TIMEOUT_S)

        try:
            try:
                fut = self._fair.submit(tenant, call)
            except admission.Saturated as e:
                # every handle thread busy AND the fair backlog full:
                # shed now instead of queueing unboundedly (the old
                # silent latency cliff)
                tracker.shed()
                await self._refuse(writer, 503, "saturated",
                                   e.retry_after_s, trace_headers)
                return True
            try:
                result = await asyncio.wrap_future(fut)
                tracker.finish("ok")
                out = json.dumps(result, default=str).encode()
                writer.write(self._response(200, out,
                                            extra_headers=trace_headers))
            except Exception as e:  # noqa: BLE001
                tracker.finish("error")
                writer.write(self._response(
                    500, json.dumps({"error": str(e)}).encode(),
                    extra_headers=trace_headers))
        finally:
            if gate is not None:
                gate.release(tenant)
        await writer.drain()
        return True

    async def _refuse(self, writer, status: int, reason: str,
                      retry_after_s: float, trace_headers) -> None:
        """429/503 refusal with the Retry-After contract: integral
        seconds, floored at 1 so a compliant client always backs off."""
        ra = 1 if not math.isfinite(retry_after_s) else \
            max(1, math.ceil(min(retry_after_s, 3600.0)))
        hdrs = list(trace_headers or ()) + [("Retry-After", str(ra))]
        writer.write(self._response(
            status,
            json.dumps({"error": reason, "retry_after_s": ra}).encode(),
            extra_headers=hdrs))
        await writer.drain()

    async def _dispatch_stream(self, writer, handle, payload, ctx3=None,
                               trace_headers=None, tracker=None):
        """Server-sent events: one `data:` frame per streamed item, then
        `data: [DONE]` (the OpenAI SSE convention). The blocking generator is
        drained on the executor; frames hop to the event loop via a queue so
        many streams interleave on one loop.

        Lifecycle: the first data frame books TTFT, every later frame books
        weighted per-token ITL samples; a client disconnect mid-stream is a
        terminal ``aborted`` event (and closing the generator propagates to
        the engine, which frees the request's slot)."""
        from ray_tpu_torch.serve._private import slo
        from ray_tpu_torch.util import tracing

        if tracker is None:
            tracker = slo.NOOP_TRACKER

        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()  # soft-bounded by put_from_thread
        stop = threading.Event()
        _END = object()

        def put_from_thread(item) -> bool:
            """Enqueue onto the loop exactly once. call_soon_threadsafe +
            put_nowait never blocks and never double-delivers (a blocking
            q.put + cancel-on-timeout could complete AND be retried). The
            soft capacity check bounds memory against a slow client; qsize
            from another thread is approximate, which only overshoots by a
            frame or two."""
            while q.qsize() >= 256:
                if stop.is_set():
                    return False
                time.sleep(0.02)
            if stop.is_set():
                return False
            try:
                loop.call_soon_threadsafe(q.put_nowait, item)
                return True
            except RuntimeError:  # loop closed
                return False

        def pump():
            try:
                with slo.activate(tracker), tracing.activate_span(
                        ctx3, "HTTP stream", kind="server"):
                    gen = handle.options(stream=True).remote(payload)
                    completed = False
                    try:
                        for item in gen:
                            if stop.is_set():
                                return
                            # lifecycle: first frame = TTFT, then weighted
                            # ITL (a frame may carry a chunk of tokens)
                            tracker.tokens(
                                len(item) if isinstance(item, (list, tuple))
                                else 1)
                            frame = (b"data: "
                                     + json.dumps(item, default=str).encode()
                                     + b"\n\n")
                            if not put_from_thread(frame):
                                return
                        completed = True
                        tracker.finish("ok")
                        put_from_thread(b"data: [DONE]\n\n")
                    finally:
                        # abandoned mid-stream ONLY (client gone): close
                        # the generator NOW so the engine-side request is
                        # cancelled and its slot frees, instead of decoding
                        # to max_new_tokens for nobody.  An exhausted
                        # stream must NOT close — cluster-mode close issues
                        # a cancel RPC, pure waste on every happy path.
                        if not completed:
                            close = getattr(gen, "close", None)
                            if close is not None:
                                close()
            except Exception as e:  # noqa: BLE001
                tracker.finish("error")
                if not stop.is_set():
                    err = (b"data: " + json.dumps({"error": str(e)}).encode()
                           + b"\n\ndata: [DONE]\n\n")
                    put_from_thread(err)
            finally:
                # terminal state for a disconnected client (finish() is
                # first-wins: a completed stream stays "ok")
                tracker.abort()
                put_from_thread(_END)

        trace_head = "".join(f"{k}: {v}\r\n" for k, v in (trace_headers or ()))
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            + trace_head.encode("latin1")
            + b"Connection: close\r\n\r\n"
        )
        await writer.drain()
        # one dedicated thread per live stream: streams are long-lived, so
        # routing them through the bounded unary pool would let N streams
        # starve every other request (the docstring's no-starvation claim)
        t = threading.Thread(target=pump, daemon=True, name="proxy-sse-pump")
        t.start()
        try:
            while True:
                frame = await q.get()
                if frame is _END:
                    break
                writer.write(frame)
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass  # client hung up; stop pulling from the generator
        finally:
            stop.set()
            # unblock a pump parked in q.put by draining leftovers
            while not q.empty():
                try:
                    q.get_nowait()
                except asyncio.QueueEmpty:
                    break


    # -- ASGI app forwarding (reference: serve/api.py:174 @serve.ingress) --

    async def _dispatch_asgi(self, writer, handle, prefix, method, target,
                             headers, body, ctx3=None,
                             trace_headers=None) -> bool:
        from ray_tpu_torch.serve._private import admission, slo
        from ray_tpu_torch.util import tracing

        path = target.split("?")[0]
        query = target.split("?", 1)[1] if "?" in target else ""
        sub_path = path[len(prefix.rstrip("/")):] or "/"
        request = {"method": method, "path": sub_path, "root_path":
                   prefix.rstrip("/"), "query": query, "headers": headers,
                   "body": body}

        def call():
            with tracing.activate_span(
                    ctx3, f"HTTP {method} {path}", kind="server",
                    attributes={"http.method": method, "http.path": path}):
                return handle.remote(request).result(timeout_s=_HANDLE_TIMEOUT_S)

        try:
            # ASGI forwards ride the same fair executor (tenant from the
            # headers only — the body is opaque to the proxy here), so a
            # saturated pool answers 503 instead of queueing unboundedly
            try:
                fut = self._fair.submit(
                    slo.extract_tenant(headers=headers), call)
            except admission.Saturated as e:
                await self._refuse(writer, 503, "saturated",
                                   e.retry_after_s, trace_headers)
                return True
            resp = await asyncio.wrap_future(fut)
            rbody = resp.get("body", b"")
            reserved = ("content-length", "connection", "transfer-encoding")
            if trace_headers:
                # replace (never duplicate) an app-supplied traceparent with
                # the ingress span's; with tracing off the app's survives
                reserved += ("traceparent",)
            hdrs = [(k, v) for k, v in resp.get("headers", [])
                    if k.lower() not in reserved]
            hdrs.extend(trace_headers or ())
            head = [f"HTTP/1.1 {resp.get('status', 200)} X"]
            for k, v in hdrs:
                head.append(f"{k}: {v}")
            head.append(f"Content-Length: {len(rbody)}")
            head.append("Connection: keep-alive")
            writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin1")
                         + bytes(rbody))
        except Exception as e:  # noqa: BLE001
            writer.write(self._response(
                500, json.dumps({"error": str(e)}).encode(),
                extra_headers=trace_headers))
        await writer.drain()
        return True

    # -- websockets (reference: serve/_private/http_util.py:335-351) -------

    async def _handle_websocket(self, reader, writer, method, target,
                                headers):
        import base64
        import hashlib
        import uuid

        path = target.split("?")[0]
        matched = match_route_full(path)
        key = headers.get("sec-websocket-key")
        if matched is None or not matched[2] or not key:
            writer.write(self._response(
                404 if matched is None else 400,
                b'{"error": "no websocket route"}', keep_alive=False))
            await writer.drain()
            return
        handle, prefix, _ = matched
        cid = uuid.uuid4().hex
        loop = asyncio.get_running_loop()
        # the whole session is PINNED to one replica: the ASGI websocket
        # session object lives there (handle.pinned() docstring). pinned()
        # itself does blocking router RPCs — keep it off the event loop
        pinned = await loop.run_in_executor(self._pool, handle.pinned)

        def call(payload):
            return pinned.remote(payload).result(timeout_s=_HANDLE_TIMEOUT_S)

        sub_path = path[len(prefix.rstrip("/")):] or "/"
        connect = {"__ws__": "connect", "id": cid, "path": sub_path,
                   "root_path": prefix.rstrip("/"), "headers": headers,
                   "method": "GET"}
        try:
            resp = await loop.run_in_executor(self._pool, call, connect)
        except Exception:  # noqa: BLE001
            writer.write(self._response(500, b'{"error": "ws connect"}',
                                        keep_alive=False))
            await writer.drain()
            return
        if not resp.get("accepted"):
            writer.write(self._response(403, b'{"error": "rejected"}',
                                        keep_alive=False))
            await writer.drain()
            return
        accept = base64.b64encode(hashlib.sha1(
            key.encode() + b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11").digest())
        writer.write(b"HTTP/1.1 101 Switching Protocols\r\n"
                     b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
                     b"Sec-WebSocket-Accept: " + accept + b"\r\n\r\n")
        await writer.drain()
        for m in resp.get("messages", []):
            writer.write(_ws_frame(m))
        await writer.drain()
        assembler = _WsMessageAssembler()
        try:
            while True:
                frame = await assembler.next_message(reader)
                if frame is None or frame[0] == 0x8:  # EOF / close
                    break
                opcode, payload = frame
                if opcode == 0x9:  # ping -> pong
                    writer.write(_ws_raw_frame(0xA, payload))
                    await writer.drain()
                    continue
                if opcode == 0xA:  # unsolicited pong keepalive: ignore
                    continue
                msg = {"__ws__": "message", "id": cid}
                if opcode == 0x1:
                    msg["text"] = payload.decode("utf-8", "replace")
                else:
                    msg["bytes"] = payload
                resp = await loop.run_in_executor(self._pool, call, msg)
                for m in resp.get("messages", []):
                    writer.write(_ws_frame(m))
                await writer.drain()
                if resp.get("closed"):
                    break
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass
        finally:
            try:
                await loop.run_in_executor(
                    self._pool, call, {"__ws__": "disconnect", "id": cid})
            except Exception:  # noqa: BLE001 — replica gone: disconnect notice is advisory
                pass
            try:
                writer.write(_ws_raw_frame(0x8, b""))
                await writer.drain()
            except Exception:  # noqa: BLE001 — client gone; the close frame is a courtesy
                pass


def _ws_raw_frame(opcode: int, payload: bytes) -> bytes:
    """Server->client frame (unmasked, RFC 6455)."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < 1 << 16:
        head += bytes([126]) + n.to_bytes(2, "big")
    else:
        head += bytes([127]) + n.to_bytes(8, "big")
    return head + payload


def _ws_frame(message: dict) -> bytes:
    if message.get("text") is not None:
        return _ws_raw_frame(0x1, message["text"].encode())
    return _ws_raw_frame(0x2, bytes(message.get("bytes", b"")))


async def _ws_read_frame(reader):
    """Read one client frame; returns (fin, opcode, unmasked payload) or
    None at EOF."""
    try:
        b1b2 = await reader.readexactly(2)
    except asyncio.IncompleteReadError:
        return None
    fin = bool(b1b2[0] & 0x80)
    opcode = b1b2[0] & 0x0F
    masked = b1b2[1] & 0x80
    n = b1b2[1] & 0x7F
    if n == 126:
        n = int.from_bytes(await reader.readexactly(2), "big")
    elif n == 127:
        n = int.from_bytes(await reader.readexactly(8), "big")
    if n > _MAX_BODY:
        return None
    mask = await reader.readexactly(4) if masked else None
    payload = await reader.readexactly(n)
    if masked and n:
        # bulk XOR via big ints — a per-byte Python loop would stall the
        # event loop for hundreds of ms on large frames
        full_mask = (mask * (n // 4 + 1))[:n]
        payload = (int.from_bytes(payload, "big")
                   ^ int.from_bytes(full_mask, "big")).to_bytes(n, "big")
    return fin, opcode, bytes(payload)


class _WsMessageAssembler:
    """Reassembles FIN=0 fragments + continuation (0x0) frames into
    messages (RFC 6455 §5.4). Control frames (ping/pong/close) may
    interleave inside a fragmented message: they are returned immediately
    while the fragment accumulator PERSISTS across calls."""

    def __init__(self):
        self._data_opcode = None
        self._parts = []

    async def next_message(self, reader):
        """(opcode, payload) — a control frame or a complete data message;
        None at EOF / protocol error / oversized message."""
        while True:
            frame = await _ws_read_frame(reader)
            if frame is None:
                return None
            fin, opcode, payload = frame
            if opcode in (0x8, 0x9, 0xA):  # control frame: never fragmented
                return opcode, payload
            if opcode not in (0x0, 0x1, 0x2):
                # reserved opcode (0x3-0x7, 0xB-0xF): RFC 6455 §5.2 requires
                # failing the connection — otherwise a FIN=1 reserved frame
                # arriving mid-fragment would falsely complete the message
                return None
            if opcode in (0x1, 0x2):
                self._data_opcode = opcode
                self._parts = [payload]
            elif opcode == 0x0:
                if self._data_opcode is None:
                    return None  # stray continuation: protocol error
                self._parts.append(payload)
            if fin and self._data_opcode is not None:
                msg = (self._data_opcode, b"".join(self._parts))
                self._data_opcode, self._parts = None, []
                return msg
            if sum(len(p) for p in self._parts) > _MAX_BODY:
                return None


def start_proxy(host: str = "127.0.0.1", port: int = 8000) -> Tuple[str, int]:
    global _proxy
    if _proxy is not None:
        return _proxy.address
    _proxy = _AsyncProxy(host, port)
    return _proxy.address


def stop_proxy():
    global _proxy
    if _proxy is not None:
        _proxy.stop()
        _proxy = None


def register_route(route_prefix: str, handle, *, asgi: bool = False):
    """``asgi=True``: the deployment mounts an ASGI app (serve/asgi.py) —
    the proxy forwards raw requests and enables websocket upgrades."""
    with _state.lock:
        _state.routes[route_prefix] = handle
        _state.asgi[route_prefix] = asgi


def unregister_route(route_prefix: str):
    with _state.lock:
        _state.routes.pop(route_prefix, None)
        _state.asgi.pop(route_prefix, None)


def clear_routes():
    with _state.lock:
        _state.routes.clear()
        _state.asgi.clear()
