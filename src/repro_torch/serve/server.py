"""JSON-lines TCP front end for the query plane (docs/serving.md), in
PyTorch: the twin of ``repro.serve.server``, byte for byte on the wire, over
``repro_torch.serve.query_plane``.

One newline-delimited JSON object per request/response; the server answers a
connection's requests in order but serves every connection concurrently on
the asyncio loop, so cross-connection queries coalesce in the underlying
:class:`~repro_torch.serve.query_plane.QueryPlane` (DESIGN.md §15).  The protocol
is deliberately minimal — a demo front door for the plane, not a product
server; examples/serve_grep.py drives it end to end.

Requests (``id`` is echoed back; binary payloads ride base64 fields):

  {"op": "ping", "id": 1}
  {"op": "add_corpus", "id": 2, "corpus": "logs", "text": "..."}      # or text_b64
  {"op": "query", "id": 3, "corpus": "logs", "patterns": ["err"],    # or patterns_b64
   "mode": "count" | "any" | "match", "k": 0}
  {"op": "stats", "id": 4}

Responses carry ``{"id", "ok"}`` plus op-specific fields; failures map the
plane's exceptions onto HTTP-style statuses: admission rejection -> 429,
unknown corpus -> 404, malformed request -> 400, unexpected dispatch
failure -> 500 (the connection stays open).
"""

from __future__ import annotations

import asyncio
import base64
import itertools
import json
from typing import Optional, Tuple

from repro_torch.serve.query_plane import (
    QueryPlane,
    QueryRejected,
    UnknownCorpus,
)

# asyncio stream buffer limit: a single add_corpus line carries the whole
# base64 payload, so the 64 KiB default would reset large uploads
STREAM_LIMIT = 1 << 27


def _decode_text(req: dict) -> bytes:
    if "text_b64" in req:
        return base64.b64decode(req["text_b64"])
    return str(req["text"]).encode("utf-8", errors="surrogateescape")


def _decode_patterns(req: dict) -> list:
    if "patterns_b64" in req:
        return [base64.b64decode(p) for p in req["patterns_b64"]]
    return [
        str(p).encode("utf-8", errors="surrogateescape")
        for p in req["patterns"]
    ]


class GrepServer:
    """asyncio TCP server wrapping a :class:`QueryPlane`.

    ``await start()`` binds (ephemeral port by default) and returns the
    (host, port) address; ``await stop()`` drains the plane and closes.
    Also an async context manager: ``async with GrepServer(plane) as addr:``.
    """

    def __init__(self, plane: QueryPlane):
        self.plane = plane
        self._server: Optional[asyncio.AbstractServer] = None
        self.address: Optional[Tuple[str, int]] = None

    async def start(
        self, host: str = "127.0.0.1", port: int = 0
    ) -> Tuple[str, int]:
        self._server = await asyncio.start_server(
            self._handle, host, port, limit=STREAM_LIMIT
        )
        sock = self._server.sockets[0].getsockname()
        self.address = (sock[0], sock[1])
        return self.address

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        await self.plane.close()

    async def __aenter__(self) -> Tuple[str, int]:
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- connection handling ------------------------------------------------

    async def _handle(self, reader, writer) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as exc:
                    resp = {"id": None, "ok": False, "status": 400,
                            "error": f"bad json: {exc.msg}"}
                else:
                    resp = await self._serve_one(req)
                writer.write(json.dumps(resp).encode() + b"\n")
                await writer.drain()
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _serve_one(self, req: dict) -> dict:
        rid = req.get("id")
        op = req.get("op")
        try:
            if op == "ping":
                return {"id": rid, "ok": True, "pong": True}
            if op == "add_corpus":
                digest = self.plane.add_corpus(
                    str(req["corpus"]), _decode_text(req)
                )
                return {"id": rid, "ok": True, "digest": digest}
            if op == "query":
                result = await self.plane.query(
                    str(req["corpus"]),
                    _decode_patterns(req),
                    mode=req.get("mode", "count"),
                    k=int(req.get("k", 0)),
                )
                resp = {
                    "id": rid, "ok": True,
                    "counts": [int(c) for c in result.counts],
                    "cached": bool(result.cached),
                    "batched": int(result.batched),
                }
                if result.positions is not None:
                    resp["positions"] = [
                        [int(i) for i in p] for p in result.positions
                    ]
                return resp
            if op == "stats":
                return {"id": rid, "ok": True, "stats": self.plane.stats(),
                        "slo": self.plane.slo_report()}
            return {"id": rid, "ok": False, "status": 400,
                    "error": f"unknown op: {op!r}"}
        except QueryRejected as exc:
            return {"id": rid, "ok": False, "status": 429,
                    "error": "rejected", "detail": str(exc)}
        except UnknownCorpus as exc:
            return {"id": rid, "ok": False, "status": 404,
                    "error": "unknown_corpus", "detail": str(exc)}
        except (KeyError, ValueError, TypeError) as exc:
            return {"id": rid, "ok": False, "status": 400,
                    "error": f"{type(exc).__name__}: {exc}"}
        except Exception as exc:  # noqa: BLE001 — e.g. a failed dispatch
            # fanned out of _run_batch; answer 500 and keep the connection
            # alive instead of tearing it (and its queued requests) down
            return {"id": rid, "ok": False, "status": 500,
                    "error": "internal", "detail": f"{exc}"}


class GrepClient:
    """Minimal JSON-lines client: one in-flight request per connection
    (open several clients for concurrency — that is exactly what makes the
    server side coalesce)."""

    _ids = itertools.count(1)

    def __init__(self, reader, writer):
        self._reader = reader
        self._writer = writer

    @classmethod
    async def connect(cls, host: str, port: int) -> "GrepClient":
        reader, writer = await asyncio.open_connection(
            host, port, limit=STREAM_LIMIT
        )
        return cls(reader, writer)

    async def request(self, **fields) -> dict:
        fields.setdefault("id", next(self._ids))
        self._writer.write(json.dumps(fields).encode() + b"\n")
        await self._writer.drain()
        line = await self._reader.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        return json.loads(line)

    async def ping(self) -> dict:
        return await self.request(op="ping")

    async def add_corpus(self, corpus: str, data: bytes) -> dict:
        return await self.request(
            op="add_corpus", corpus=corpus,
            text_b64=base64.b64encode(bytes(data)).decode("ascii"),
        )

    async def query(
        self, corpus: str, patterns, *, mode: str = "count", k: int = 0
    ) -> dict:
        return await self.request(
            op="query", corpus=corpus, mode=mode, k=k,
            patterns_b64=[
                base64.b64encode(bytes(p)).decode("ascii") for p in patterns
            ],
        )

    async def stats(self) -> dict:
        return await self.request(op="stats")

    async def close(self) -> None:
        self._writer.close()
        try:
            await self._writer.wait_closed()
        except (ConnectionError, OSError):
            pass
