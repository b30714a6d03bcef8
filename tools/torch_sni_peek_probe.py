#!/usr/bin/env python3
"""How often each package's SNI proxy peeks a ClientHello that arrives in two
writes, and the CPU time its process spends while it waits.

    python3 tools/torch_sni_peek_probe.py [--pause 0.5]

For the reference (dragonfly2_tpu) and the port (dragonfly2_tpu_torch) in
turn: an ``SniProxy`` on a free localhost port whose tunnel is replaced by
a stub that records the routed name; a client sends the first 40 bytes of a
real ClientHello, sleeps ``--pause`` seconds, then sends the rest. Counts
the peeks (``parse_client_hello_sni`` calls) and this process's CPU seconds
over the pause, and prints one JSON line per package. Host code only: no
card is needed.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import json
import ssl
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def client_hello(name: str) -> bytes:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    inbio, outbio = ssl.MemoryBIO(), ssl.MemoryBIO()
    obj = ctx.wrap_bio(inbio, outbio, server_hostname=name)
    try:
        obj.do_handshake()
    except ssl.SSLWantReadError:
        pass
    return outbio.read()


async def probe(pkg: str, pause: float) -> dict:
    proxy_mod = importlib.import_module(f"{pkg}.daemon.proxy")
    mitm = importlib.import_module(f"{pkg}.security.mitm")
    peeks = []
    real = mitm.parse_client_hello_sni
    mitm.parse_client_hello_sni = lambda data: peeks.append(len(data)) or real(data)
    routed = asyncio.get_running_loop().create_future()

    async def tunnel(name, reader, writer):
        routed.set_result(name)

    sni = proxy_mod.SniProxy(proxy_mod.ProxyServer(None))
    sni._handle_tunnel = tunnel
    await sni.start()
    try:
        hello = client_hello("registry.example")
        _, writer = await asyncio.open_connection("127.0.0.1", sni.port)
        writer.write(hello[:40])
        await writer.drain()
        t0 = time.process_time()
        await asyncio.sleep(pause)
        writer.write(hello[40:])
        await writer.drain()
        name = await asyncio.wait_for(routed, 10.0)
        cpu = time.process_time() - t0
        writer.close()
    finally:
        await sni.stop()
        mitm.parse_client_hello_sni = real
    return {"package": pkg, "pause_s": pause, "peeks": len(peeks), "cpu_s": round(cpu, 4), "routed": name}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pause", type=float, default=0.5, help="seconds between the two writes")
    args = ap.parse_args()
    for pkg in ("dragonfly2_tpu", "dragonfly2_tpu_torch"):
        print(json.dumps(asyncio.run(probe(pkg, args.pause))))


if __name__ == "__main__":
    main()
