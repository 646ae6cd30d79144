"""Message-passing layer for all control-plane traffic.

TPU-native equivalent of the reference's gRPC wrapper layer
(reference: src/ray/rpc/grpc_server.h, client_call.h,
retryable_grpc_client.cc).  We use length-prefixed pickled frames over TCP
instead of gRPC+protobuf: every process (GCS, raylet, each worker) runs one
``RpcServer`` on a background thread, so any process can both serve requests
and receive pushed messages (the pubsub plane rides the same sockets).

Deterministic fault injection mirrors the reference's RpcFailure chaos hooks
(reference: src/ray/rpc/rpc_chaos.h:23-35, env RAY_testing_rpc_failure): set
``RAY_TPU_testing_rpc_failure="Method=max_failures:req_prob:resp_prob"`` and
matching calls will deterministically drop the request or the response.
"""

from __future__ import annotations

import inspect
import logging
import pickle
import random
import socket
import socketserver
import struct
import threading
import time
from concurrent.futures import Future

from ray_tpu_torch._private.utils import DaemonExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import global_config

logger = logging.getLogger(__name__)

_HEADER = struct.Struct("<QQ")  # (msg_id, payload_len)

# ---------------------------------------------------------------------------
# Frame bodies.  Two encodings share the wire:
#
# - classic: one pickled blob (protocol 5, starts with the PROTO opcode
#   b"\x80") — everything before this layer existed.
# - out-of-band (protocol-5 fast path): pickle.dumps(obj, buffer_callback=)
#   splits PickleBuffer-backed payloads (inline task args/returns, object
#   chunks, numpy arrays) out of the in-band stream; the frame is then
#   [0xF5][u32 nbufs][u64 inband_len][u64 len_i ...][inband][buf_0][buf_1]…
#   and every part is handed to the socket as its own iovec (sendmsg), so
#   large payloads are never copied into a joined frame on the send side.
#
# The first body byte disambiguates (a protocol-2+ pickle always starts
# with 0x80).  Receivers read bodies into a fresh bytearray and hand the
# buffers to pickle.loads(buffers=...) as writable memoryview slices —
# one copy total on the receive side.
# ---------------------------------------------------------------------------

_OOB_MAGIC = 0xF5
_OOB_HEAD = struct.Struct("<BIQ")  # (magic, nbufs, inband_len)
_LEN64 = struct.Struct("<Q")
# sendmsg iovec count is bounded by IOV_MAX (1024 on linux); stay well under
_MAX_IOVECS = 512


def encode_body(obj) -> List:
    """Encode a frame body; returns the list of bytes-like parts to send
    (one element for classic frames, header+inband+buffers for OOB)."""
    if not global_config().rpc_oob_frames_enabled:
        return [pickle.dumps(obj, protocol=5)]
    pbufs: List[pickle.PickleBuffer] = []
    inband = pickle.dumps(obj, protocol=5, buffer_callback=pbufs.append)
    if not pbufs:
        return [inband]
    raws = []
    for pb in pbufs:
        try:
            raws.append(pb.raw())
        except BufferError:  # non-contiguous: one copy to flatten
            raws.append(memoryview(bytes(pb)))
    head = bytearray(_OOB_HEAD.pack(_OOB_MAGIC, len(raws), len(inband)))
    for r in raws:
        head += _LEN64.pack(r.nbytes)
    return [bytes(head), inband, *raws]


def decode_body(body) -> Any:
    """Decode a frame body produced by encode_body (either encoding).
    ``body`` should be a writable buffer (bytearray) so out-of-band numpy
    arrays reconstruct writable, matching in-band semantics."""
    mv = memoryview(body)
    if mv.nbytes == 0 or mv[0] != _OOB_MAGIC:
        return pickle.loads(body)
    _, nbufs, inband_len = _OOB_HEAD.unpack_from(mv, 0)
    offset = _OOB_HEAD.size
    lengths = []
    for _ in range(nbufs):
        (n,) = _LEN64.unpack_from(mv, offset)
        lengths.append(n)
        offset += _LEN64.size
    inband = mv[offset:offset + inband_len]
    offset += inband_len
    buffers = []
    for n in lengths:
        buffers.append(mv[offset:offset + n])
        offset += n
    return pickle.loads(inband, buffers=buffers)


def oob_wrap(data):
    """Wrap a blob in PickleBuffer so encode_body carries it out-of-band
    (zero-copy straight to the socket).  Only for payloads consumed on
    their first hop — after transit the receiver holds a memoryview, which
    cannot be re-pickled.  Small blobs pass through unchanged (an iovec
    per tiny buffer costs more than the copy it saves)."""
    cfg = global_config()
    if (cfg.rpc_oob_frames_enabled
            and isinstance(data, (bytes, bytearray, memoryview))
            and len(data) >= cfg.rpc_oob_min_buffer_bytes):
        return pickle.PickleBuffer(data)
    return data


def encode_frame(method: str, payload: Any) -> List:
    """Pre-encode one request body for ``RpcClient.call_async_frame``.

    The pubsub plane uses this to pickle a publish payload ONCE and ship
    the identical frame to every subscriber (flat fan-out used to
    re-pickle the same message N times); the returned parts list is
    read-only and safe to hand to many clients concurrently."""
    return encode_body((method, payload))


def _body_len(parts: List) -> int:
    return sum(memoryview(p).nbytes for p in parts)


def _sendall_parts(sock: socket.socket, parts: List) -> None:
    """Vectored send of every part (sendmsg), looping over partial writes;
    falls back to a joined sendall where sendmsg is unavailable."""
    if not hasattr(sock, "sendmsg") or len(parts) > _MAX_IOVECS:
        sock.sendall(b"".join(bytes(p) if not isinstance(p, (bytes, bytearray))
                              else p for p in parts))
        return
    views = [memoryview(p).cast("B") for p in parts]
    while views:
        sent = sock.sendmsg(views)
        while views and sent:
            first = views[0].nbytes
            if sent >= first:
                sent -= first
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


class RemoteError(RpcError):
    """The handler on the remote side raised; carries the remote traceback."""

    def __init__(self, message, remote_traceback=""):
        super().__init__(message)
        self.remote_traceback = remote_traceback


# ---------------------------------------------------------------------------
# Chaos injection (reference: src/ray/rpc/rpc_chaos.h)
# ---------------------------------------------------------------------------


class _RpcChaos:
    """Deterministic request/response drop injection for tests."""

    def __init__(self, spec: str):
        self._rules: Dict[str, Tuple[int, float, float]] = {}
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._rng = random.Random(0)
        if spec:
            for entry in spec.split(","):
                method, params = entry.split("=")
                max_failures, req_prob, resp_prob = params.split(":")
                self._rules[method] = (int(max_failures), float(req_prob), float(resp_prob))

    def check(self, method: str) -> str:
        """Returns 'ok', 'drop_request' or 'drop_response'."""
        if method not in self._rules:
            return "ok"
        with self._lock:
            max_failures, req_prob, resp_prob = self._rules[method]
            n = self._counts.get(method, 0)
            if n >= max_failures:
                return "ok"
            r = self._rng.random()
            if r < req_prob:
                self._counts[method] = n + 1
                return "drop_request"
            if r < req_prob + resp_prob:
                self._counts[method] = n + 1
                return "drop_response"
            return "ok"


_chaos: Optional[_RpcChaos] = None


def _get_chaos() -> _RpcChaos:
    global _chaos
    if _chaos is None:
        _chaos = _RpcChaos(global_config().testing_rpc_failure)
    return _chaos


def reset_chaos_for_testing(spec: str):
    global _chaos
    _chaos = _RpcChaos(spec)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 4 * 1024 * 1024))
        if not chunk:
            raise ConnectionLost("socket closed")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


class _BufferedReader:
    """Frame reader that pulls a chunk per recv and parses as many frames
    as it holds: back-to-back frames (pipelined pushes, coalesced replies)
    share one syscall instead of paying header-recv + body-recv each —
    recv costs ~100µs on some kernels, which dominated per-task cost at
    high task rates.  The consumed prefix advances by offset (no O(n)
    buffer shifting), and body bytes beyond what's buffered are received
    straight into their final buffer (no double copy for large frames)."""

    __slots__ = ("_sock", "_buf", "_pos")
    _CHUNK = 1 << 18

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""
        self._pos = 0

    def _fill(self):
        if self._pos >= len(self._buf):
            self._buf = b""
            self._pos = 0
        chunk = self._sock.recv(self._CHUNK)
        if not chunk:
            raise ConnectionLost("socket closed")
        if self._buf:
            self._buf = self._buf[self._pos:] + chunk
            self._pos = 0
        else:
            self._buf = chunk

    def read_header(self) -> Tuple[int, int]:
        while len(self._buf) - self._pos < _HEADER.size:
            self._fill()
        msg_id, length = _HEADER.unpack_from(self._buf, self._pos)
        self._pos += _HEADER.size
        return msg_id, length

    def read_body(self, n: int) -> bytearray:
        avail = len(self._buf) - self._pos
        if avail >= n:
            out = bytearray(memoryview(self._buf)[self._pos:self._pos + n])
            self._pos += n
            return out
        out = bytearray(n)
        if avail:
            out[:avail] = memoryview(self._buf)[self._pos:]
        self._buf = b""
        self._pos = 0
        view = memoryview(out)
        got = avail
        while got < n:
            r = self._sock.recv_into(view[got:], n - got)
            if not r:
                raise ConnectionLost("socket closed")
            got += r
        return out


def _err_frame(exc: BaseException, tb: str) -> bytes:
    """Wire frame for an error reply. A reply MUST always go out (callers
    may wait with timeout=None), so an unpicklable exception is replaced by
    an RpcError carrying its type and message."""
    try:
        return pickle.dumps(("err", (str(exc), tb, exc)), protocol=5)
    except Exception:  # noqa: BLE001
        return pickle.dumps(
            ("err", (str(exc), tb,
                     RpcError(f"{type(exc).__name__}: {exc} "
                              "(original exception unpicklable)"))),
            protocol=5)


class RpcServer:
    """Serves registered handlers; one handler thread pool per server.

    Handlers are ``fn(payload_dict) -> reply`` callables registered by method
    name.  A handler may return ``DELAYED_REPLY`` and later call
    ``server.send_reply(reply_token, value)`` — used for long-poll style
    endpoints (object waits, pubsub long-polls), mirroring how the reference's
    gRPC handlers hold ``SendReplyCallback`` for deferred replies.
    """

    DELAYED_REPLY = object()

    def __init__(self, host: str = "127.0.0.1", num_threads: int = 16, port: int = 0,
                 handshake_token: Optional[str] = None):
        """``handshake_token``: require every connection to present this
        token as a raw-bytes preamble BEFORE any frame is parsed — the frame
        payloads are pickles, so an exposed port must authenticate ahead of
        the first ``pickle.loads`` (used by the ray:// client server when
        bound off-loopback)."""
        # method -> (callable, wants_reply_token); arity is resolved ONCE at
        # register() time via inspect.signature — per-dispatch __code__
        # poking broke for non-function callables (functools.partial, bound
        # builtins) and cost a getattr chain on every RPC
        self._handlers: Dict[str, Tuple[Callable, bool]] = {}
        # optional fn(method, seconds) timing every synchronous handler
        # dispatch — the GCS hangs its per-method RPC latency histogram here
        self.observer: Optional[Callable[[str, float], None]] = None
        self._pool = DaemonExecutor(max_workers=num_threads, thread_name_prefix="rpc-handler")
        self._lock = threading.Lock()
        # live client connections: shutdown() must sever them, or peers keep
        # sending into a dead server and wait out their full RPC timeout
        # instead of seeing ConnectionLost and reconnecting (GCS restart path)
        self._conns: set = set()
        self._conn_lock = threading.Lock()
        self._handshake = handshake_token.encode() if handshake_token else None
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                send_lock = threading.Lock()
                with outer._conn_lock:
                    outer._conns.add(sock)
                try:
                    if outer._handshake is not None:
                        import hmac

                        preamble = _recv_exact(sock, 4 + len(outer._handshake))
                        if not hmac.compare_digest(
                                preamble, b"RTPU" + outer._handshake):
                            sock.close()
                            return
                    reader = _BufferedReader(sock)
                    while True:
                        msg_id, length = reader.read_header()
                        body = reader.read_body(length)
                        outer._pool.submit(outer._dispatch, sock, send_lock, msg_id, body)
                except (ConnectionLost, ConnectionResetError, OSError):
                    pass
                finally:
                    with outer._conn_lock:
                        outer._conns.discard(sock)

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self._host, self._port = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True, name="rpc-server")
        self._thread.start()

    @property
    def address(self) -> Tuple[str, int]:
        return (self._host, self._port)

    @staticmethod
    def _wants_reply_token(fn: Callable) -> bool:
        """True when the handler accepts a second positional argument (the
        deferred-reply token).  Works for any callable — plain functions,
        bound methods, functools.partial, builtins — falling back to
        payload-only for signatures that cannot be introspected."""
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            return False
        positional = sum(
            1 for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD))
        return positional >= 2

    def register(self, method: str, fn: Callable):
        self._handlers[method] = (fn, self._wants_reply_token(fn))

    def register_all(self, obj: Any, prefix: str = ""):
        """Register every public method of ``obj`` named ``Handle*``."""
        for name in dir(obj):
            if name.startswith("Handle"):
                self.register(prefix + name[len("Handle"):], getattr(obj, name))

    def _dispatch(self, sock, send_lock, msg_id, body):
        try:
            method, payload = decode_body(body)
        except Exception:
            logger.exception("rpc: undecodable frame")
            return
        chaos = _get_chaos().check(method)
        if chaos == "drop_request":
            return  # server never saw it
        entry = self._handlers.get(method)
        reply_token = (sock, send_lock, msg_id)
        try:
            if entry is None:
                raise RpcError(f"no handler for method {method!r}")
            handler, wants_token = entry
            observer = self.observer
            t0 = time.perf_counter() if observer is not None else 0.0
            result = handler(payload, reply_token) if wants_token else handler(payload)
            if observer is not None:
                try:
                    observer(method, time.perf_counter() - t0)
                except Exception:  # noqa: BLE001 — metrics never fail an RPC
                    pass
            if result is RpcServer.DELAYED_REPLY:
                return
            parts = encode_body(("ok", result))
        except Exception as e:  # noqa: BLE001
            import traceback

            parts = [_err_frame(e, traceback.format_exc())]
        if chaos == "drop_response":
            return
        self._send_frame(sock, send_lock, msg_id, parts)

    def send_reply(self, reply_token, value):
        sock, send_lock, msg_id = reply_token
        try:
            parts = encode_body(("ok", value))
        except Exception as e:  # noqa: BLE001 — a reply MUST go out, or
            # callers with timeout=None block forever
            parts = [_err_frame(RpcError(f"reply unpicklable: {e}"), "")]
        self._send_frame(sock, send_lock, msg_id, parts)

    def send_error_reply(self, reply_token, exc: Exception):
        sock, send_lock, msg_id = reply_token
        self._send_frame(sock, send_lock, msg_id, [_err_frame(exc, "")])

    @staticmethod
    def _send_frame(sock, send_lock, msg_id, parts):
        try:
            with send_lock:
                # graftlint: allow(blocking-under-lock) — the send lock
                # exists to serialize frame writes on this socket;
                # interleaved sendalls would corrupt the wire framing
                _sendall_parts(
                    sock, [_HEADER.pack(msg_id, _body_len(parts)), *parts])
        except OSError:
            pass  # client went away; nothing to do

    def shutdown(self):
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:  # noqa: BLE001 — server already down is the goal of shutdown
            pass
        with self._conn_lock:
            conns = list(self._conns)
            self._conns.clear()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._pool.shutdown(wait=False, cancel_futures=True)


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class RpcClient:
    """Thread-safe client with concurrent in-flight requests and retry.

    Mirrors the reference's RetryableGrpcClient (retryable_grpc_client.cc):
    calls retry on connection loss up to a deadline, with exponential backoff.
    """

    def __init__(self, address: Tuple[str, int], connect_timeout: Optional[float] = None,
                 handshake_token: Optional[str] = None):
        self._handshake = handshake_token.encode() if handshake_token else None
        self._address = tuple(address)
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._futures: Dict[int, Future] = {}
        self._next_id = 0
        self._reader: Optional[threading.Thread] = None
        self._closed = False
        self._connect_timeout = connect_timeout or global_config().rpc_connect_timeout_s

    @property
    def address(self):
        return self._address

    def _ensure_connected(self):
        with self._state_lock:
            if self._sock is not None:
                return
            if self._closed:
                raise ConnectionLost("client closed")
            # Single attempt: callers that need to wait for a server to come
            # up use RpcClient.call's retry loop; async callers want fast
            # failure (e.g. the actor pipeline probing a dead incarnation).
            try:
                sock = socket.create_connection(self._address, timeout=self._connect_timeout)
            except OSError:
                raise ConnectionLost(f"cannot connect to {self._address}")
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(None)
            if self._handshake is not None:
                try:
                    # graftlint: allow(blocking-under-lock) — reconnect is
                    # single-flight under the state lock by design: other
                    # senders need this socket before they can proceed
                    sock.sendall(b"RTPU" + self._handshake)
                except OSError:
                    raise ConnectionLost(f"handshake to {self._address} failed")
            self._sock = sock
            self._reader = threading.Thread(target=self._read_loop, args=(sock,), daemon=True, name="rpc-client-reader")
            self._reader.start()

    def _read_loop(self, sock):
        try:
            reader = _BufferedReader(sock)
            while True:
                msg_id, length = reader.read_header()
                body = reader.read_body(length)
                fut = self._futures.pop(msg_id, None)
                if fut is None:
                    continue
                try:
                    status, value = decode_body(body)
                except Exception as e:  # noqa: BLE001 — e.g. an exception
                    # class importable only on the server; fail THIS call,
                    # not the whole connection
                    fut.set_exception(RemoteError(
                        f"undecodable reply: {e}", ""))
                    continue
                if status == "ok":
                    fut.set_result(value)
                else:
                    msg, tb, exc = value
                    if isinstance(exc, Exception) and not isinstance(exc, RpcError):
                        fut.set_exception(exc)
                    else:
                        fut.set_exception(RemoteError(msg, tb))
        except (ConnectionLost, ConnectionResetError, OSError):
            self._on_disconnect(sock)

    def _on_disconnect(self, sock):
        with self._state_lock:
            if self._sock is sock:
                self._sock = None
        stale = list(self._futures.items())
        self._futures.clear()
        for _, fut in stale:
            if not fut.done():
                fut.set_exception(ConnectionLost(f"connection to {self._address} lost"))

    def call_async(self, method: str, payload: Any = None) -> Future:
        return self.call_async_frame(encode_body((method, payload)))

    def call_async_frame(self, parts: List) -> Future:
        """Send a body pre-encoded by ``encode_frame`` — the pickle-once
        publish seam (``call_async`` is this plus a per-call encode; the
        frame parts are shared by-reference across every recipient)."""
        self._ensure_connected()
        with self._state_lock:
            self._next_id += 1
            msg_id = self._next_id
        fut: Future = Future()
        self._futures[msg_id] = fut
        try:
            with self._send_lock:
                # graftlint: allow(blocking-under-lock) — the send lock
                # serializes frame writes; interleaving would corrupt
                # the wire framing
                _sendall_parts(
                    self._sock,
                    [_HEADER.pack(msg_id, _body_len(parts)), *parts])
        except (OSError, AttributeError):
            self._futures.pop(msg_id, None)
            with self._state_lock:
                self._sock = None
            raise ConnectionLost(f"send to {self._address} failed")
        return fut

    def call_async_batch(self, calls) -> "List[Future]":
        """Send MANY requests in ONE vectored socket write (one sendmsg
        syscall instead of one per call) — the pipelined task-push fast
        path.  ``calls`` is a list of (method, payload); returns one Future
        per call, in order.  The server reads length-prefixed frames in a
        loop, so coalescing frames needs no server-side support."""
        self._ensure_connected()
        futs: List[Future] = []
        ids: List[int] = []
        parts: List = []
        with self._state_lock:
            for method, payload in calls:
                self._next_id += 1
                msg_id = self._next_id
                fut = Future()
                self._futures[msg_id] = fut
                futs.append(fut)
                ids.append(msg_id)
                body = encode_body((method, payload))
                parts.append(_HEADER.pack(msg_id, _body_len(body)))
                parts.extend(body)
        try:
            with self._send_lock:
                # graftlint: allow(blocking-under-lock) — see send_parts:
                # the send lock is the wire-framing serializer
                _sendall_parts(self._sock, parts)
        except (OSError, AttributeError):
            for msg_id in ids:
                self._futures.pop(msg_id, None)
            with self._state_lock:
                self._sock = None
            for fut in futs:
                if not fut.done():
                    fut.set_exception(
                        ConnectionLost(f"send to {self._address} failed"))
        return futs

    _DEFAULT_TIMEOUT = object()

    def call(self, method: str, payload: Any = None, timeout: Any = _DEFAULT_TIMEOUT,
             retry_deadline: Optional[float] = None) -> Any:
        """Synchronous call with transparent reconnect-and-retry.

        timeout: seconds to wait for the reply; omitted -> the global GCS
        RPC timeout; explicit ``None`` -> wait forever (lease requests and
        task pushes legitimately block until resources free / tasks finish).
        """
        if timeout is RpcClient._DEFAULT_TIMEOUT:
            timeout = global_config().gcs_rpc_timeout_s
        if retry_deadline is not None:
            deadline = time.monotonic() + retry_deadline
        else:
            # timeout=None blocks forever on a HEALTHY connection, but the
            # reconnect loop for a DEAD peer stays bounded — callers must
            # see ConnectionLost, not retry into the void.
            deadline = time.monotonic() + (
                timeout if timeout is not None else global_config().gcs_rpc_timeout_s)
        delay = 0.02
        while True:
            try:
                fut = self.call_async(method, payload)
                return fut.result(timeout=timeout)
            except ConnectionLost:
                # a client closed() by our own shutdown must fail NOW: the
                # reconnect loop would otherwise keep a pool thread alive
                # (retrying a dead peer) for the full deadline — the leaked
                # 'gcs-actor-create' threads the lane hygiene test caught
                if self._closed or time.monotonic() > deadline:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 0.5)

    def notify(self, method: str, payload: Any = None):
        """Fire-and-forget (reply is still sent by the server, but ignored)."""
        try:
            fut = self.call_async(method, payload)
            fut.add_done_callback(lambda f: f.exception())  # swallow
        except ConnectionLost:
            pass

    def close(self):
        with self._state_lock:
            self._closed = True
            sock = self._sock
            self._sock = None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


class ClientPool:
    """Caches one RpcClient per address. Shared by a whole process."""

    def __init__(self):
        self._clients: Dict[Tuple[str, int], RpcClient] = {}
        self._lock = threading.Lock()

    def get(self, address: Tuple[str, int]) -> RpcClient:
        address = tuple(address)
        with self._lock:
            cli = self._clients.get(address)
            if cli is None:
                cli = RpcClient(address)
                self._clients[address] = cli
            return cli

    def invalidate(self, address: Tuple[str, int]):
        with self._lock:
            cli = self._clients.pop(tuple(address), None)
        if cli is not None:
            cli.close()

    def close_all(self):
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            c.close()
