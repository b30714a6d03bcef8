"""HTTPS-interception support: CA-backed leaf-cert forging + SNI parsing;
the port of dragonfly2_tpu/security/mitm.py.

Parity with reference client/daemon/proxy/cert.go (genLeafCert: forge a leaf
for the intercepted host, signed by the proxy's CA, with an LRU cache) and the
SNI extraction that proxy_sni.go gets from Go's tls.ClientHelloInfo. Python's
ssl needs the ClientHello parsed by hand when the proxy must decide
hijack-vs-tunnel *before* any TLS handshake, so a minimal parser lives here.
"""

from __future__ import annotations

import logging
import ssl
import tempfile
from collections import OrderedDict
from pathlib import Path

from dragonfly2_tpu_torch.security.ca import CertificateAuthority

logger = logging.getLogger(__name__)


class CertForger:
    """Forge per-host leaf certificates signed by the cluster CA, served as
    ready ssl server contexts with an LRU cache (ref cert.go certCache)."""

    def __init__(self, ca: CertificateAuthority, *, cache_size: int = 256,
                 leaf_days: int = 7):
        self.ca = ca
        self.cache_size = cache_size
        self.leaf_days = leaf_days
        self._cache: OrderedDict[str, ssl.SSLContext] = OrderedDict()
        # ssl.load_cert_chain only reads files; keep forged pairs in a
        # private tmpdir that dies with the forger
        self._tmp = tempfile.TemporaryDirectory(prefix="df-mitm-")

    def context_for(self, host: str) -> ssl.SSLContext:
        ctx = self._cache.get(host)
        if ctx is not None:
            self._cache.move_to_end(host)
            return ctx
        issued = self.ca.issue(host, sans=[host], days=self.leaf_days,
                               server=True, client=False)
        safe = host.replace("/", "_").replace(":", "_")
        cert_path = Path(self._tmp.name) / f"{safe}.crt"
        key_path = Path(self._tmp.name) / f"{safe}.key"
        cert_path.write_bytes(issued.cert_pem)
        key_path.write_bytes(issued.key_pem)
        key_path.chmod(0o600)
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(str(cert_path), str(key_path))
        self._cache[host] = ctx
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
        logger.debug("forged leaf certificate for %s", host)
        return ctx

    def close(self) -> None:
        self._tmp.cleanup()


def parse_client_hello_sni(data: bytes) -> tuple[str, str | None]:
    """Extract the SNI server_name from raw ClientHello bytes.

    Returns (status, name): status is "ok" (name set), "incomplete" (feed more
    bytes), or "none" (not a ClientHello / no SNI extension).
    """
    try:
        if len(data) < 5:
            return "incomplete", None
        if data[0] != 0x16:  # not a TLS handshake record
            return "none", None
        rec_len = int.from_bytes(data[3:5], "big")
        if len(data) < 5 + rec_len:
            return "incomplete", None
        hs = data[5 : 5 + rec_len]
        if len(hs) < 4 or hs[0] != 0x01:  # not ClientHello
            return "none", None
        body_len = int.from_bytes(hs[1:4], "big")
        body = hs[4 : 4 + body_len]
        if len(body) < body_len:
            # ClientHello spanning multiple records — rare; callers treat a
            # persistent "incomplete" as tunnel-by-default
            return "incomplete", None
        off = 2 + 32  # client_version + random
        sid_len = body[off]
        off += 1 + sid_len
        cs_len = int.from_bytes(body[off : off + 2], "big")
        off += 2 + cs_len
        comp_len = body[off]
        off += 1 + comp_len
        if off + 2 > len(body):
            return "none", None  # no extensions block
        ext_total = int.from_bytes(body[off : off + 2], "big")
        off += 2
        end = min(off + ext_total, len(body))
        while off + 4 <= end:
            ext_type = int.from_bytes(body[off : off + 2], "big")
            ext_len = int.from_bytes(body[off + 2 : off + 4], "big")
            off += 4
            if ext_type == 0x0000:  # server_name
                sl = body[off : off + ext_len]
                if len(sl) >= 5 and sl[2] == 0x00:  # host_name entry
                    name_len = int.from_bytes(sl[3:5], "big")
                    return "ok", sl[5 : 5 + name_len].decode("ascii", "replace")
                return "none", None
            off += ext_len
        return "none", None
    except (IndexError, ValueError):
        return "none", None
