"""Asyncio streaming HTTP ingress for the decode engine.

The JAX package's ``repro.serve.http``, ported as is: a dependency-free
front door over :meth:`Server.submit_decode` / :meth:`Server.stream` —
stdlib ``asyncio`` only, no web framework:

- ``POST /generate`` with a JSON body ``{"prompt": [int, ...],
  "max_new": N}`` answers ``200`` with ``Transfer-Encoding: chunked`` and
  streams ONE token id per line, flushed per generate step — a client
  reads tokens while later steps are still running, and a slow client on
  one connection never blocks another request's stream (per-rid queues).
- ``GET /healthz`` answers a one-line JSON status.

Requests shed by admission control answer ``503`` (loud, like
:class:`~repro_torch.serve.server.AdmissionError` everywhere else);
malformed bodies answer ``400``.

Concurrency model: the engine is synchronous and single-state, so ALL
engine work (submit + token pulls) funnels through a single-thread
executor — HTTP concurrency lives in the event loop, engine steps stay
strictly serialized.  Pulling tokens for one connection advances every
occupied slot (that is continuous batching), so concurrent streams make
each other progress instead of queueing behind one another.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
from typing import Any, Dict, Optional, Tuple

from .server import AdmissionError, Server

_MAX_HEADER_BYTES = 64 * 1024
_MAX_BODY_BYTES = 4 * 1024 * 1024
_SENTINEL = object()


class EngineHTTPServer:
    """A tiny asyncio HTTP/1.1 server streaming engine tokens.

    ::

        front = EngineHTTPServer(server)        # server has an engine
        host, port = await front.start()        # port=0 picks a free one
        ...
        await front.stop()
    """

    def __init__(self, server: Server, host: str = "127.0.0.1",
                 port: int = 0):
        if server.engine is None:
            raise ValueError(
                "EngineHTTPServer fronts the decode engine: construct the "
                "Server with engine=DecodeEngine(...)")
        self.server = server
        self.host = host
        self.port = port
        self._srv: Optional[asyncio.AbstractServer] = None
        # ONE thread: every submit_decode / stream pull serializes here,
        # so the engine's persistent state never sees concurrent mutation
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="engine-http")

    async def start(self) -> Tuple[str, int]:
        self._srv = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._srv.sockets[0].getsockname()[1]
        return self.host, self.port

    async def stop(self) -> None:
        if self._srv is not None:
            self._srv.close()
            await self._srv.wait_closed()
            self._srv = None
        self._pool.shutdown(wait=True)

    # -- request plumbing ---------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            writer.close()
            return
        if len(head) > _MAX_HEADER_BYTES:
            await self._respond(writer, 431, {"error": "headers too large"})
            return
        try:
            request_line, headers = self._parse_head(head)
            method, path = request_line
            length = int(headers.get("content-length", "0"))
            if length > _MAX_BODY_BYTES:
                await self._respond(writer, 413, {"error": "body too large"})
                return
            body = await reader.readexactly(length) if length else b""
        except (ValueError, asyncio.IncompleteReadError) as e:
            await self._respond(writer, 400, {"error": f"bad request: {e}"})
            return
        try:
            if method == "POST" and path == "/generate":
                await self._generate(writer, body)
            elif method == "GET" and path == "/healthz":
                eng = self.server.engine
                await self._respond(writer, 200, {
                    "status": "ok", "slots": eng.num_slots,
                    "steps": eng.n_steps, "tokens": eng.n_tokens})
            else:
                await self._respond(writer, 404,
                                    {"error": f"no route {method} {path}"})
        except ConnectionError:
            pass                               # client went away mid-stream
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except ConnectionError:
                pass

    @staticmethod
    def _parse_head(head: bytes) -> Tuple[Tuple[str, str], Dict[str, str]]:
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split()
        if len(parts) != 3:
            raise ValueError(f"malformed request line {lines[0]!r}")
        headers = {}
        for line in lines[1:]:
            if not line:
                continue
            name, _, value = line.partition(":")
            headers[name.strip().lower()] = value.strip()
        return (parts[0].upper(), parts[1]), headers

    @staticmethod
    async def _respond(writer: asyncio.StreamWriter, status: int,
                       payload: Dict[str, Any]) -> None:
        body = (json.dumps(payload) + "\n").encode()
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  413: "Payload Too Large", 431: "Headers Too Large",
                  503: "Service Unavailable"}.get(status, "Error")
        writer.write(
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n".encode() + body)
        await writer.drain()

    # -- the streaming route ------------------------------------------------
    async def _generate(self, writer: asyncio.StreamWriter,
                        body: bytes) -> None:
        try:
            req = json.loads(body.decode() or "{}")
            prompt = req["prompt"]
            max_new = int(req.get("max_new", 16))
            if (not isinstance(prompt, list) or not prompt
                    or not all(isinstance(t, int) for t in prompt)):
                raise ValueError("prompt must be a non-empty list of ints")
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            await self._respond(writer, 400, {"error": f"bad request: {e}"})
            return
        loop = asyncio.get_running_loop()
        try:
            rid = await loop.run_in_executor(
                self._pool, lambda: self.server.submit_decode(
                    prompt, max_new=max_new))
        except AdmissionError as e:
            await self._respond(writer, 503, {"error": str(e)})
            return
        except ValueError as e:
            await self._respond(writer, 400, {"error": str(e)})
            return
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/plain; charset=utf-8\r\n"
            b"Transfer-Encoding: chunked\r\n"
            b"Connection: close\r\n"
            + f"X-Request-Id: {rid}\r\n\r\n".encode())
        await writer.drain()
        stream = self.server.stream(rid)

        def _pull():
            try:
                return next(stream)
            except StopIteration:
                return _SENTINEL

        try:
            while True:
                tok = await loop.run_in_executor(self._pool, _pull)
                if tok is _SENTINEL:
                    break
                chunk = f"{tok}\n".encode()
                writer.write(f"{len(chunk):X}\r\n".encode() + chunk + b"\r\n")
                await writer.drain()
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        except AdmissionError:
            # rid shed mid-stream (fault): the truncated chunked body is
            # the loud signal — no terminal chunk is ever written
            pass
