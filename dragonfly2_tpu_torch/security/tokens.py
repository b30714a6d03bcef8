"""HMAC-SHA256 signed tokens (the manager's JWT equivalent,
manager/middlewares/jwt.go — same three-part base64url shape, HS256 only,
no external jwt dependency): the port of dragonfly2_tpu/security/tokens.py.
A token signed by either package verifies in the other."""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Any


class TokenError(Exception):
    pass


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


_HEADER = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}, separators=(",", ":")).encode())


def sign_token(claims: dict[str, Any], secret: str, *, ttl: float = 7 * 24 * 3600) -> str:
    payload = dict(claims)
    payload.setdefault("iat", int(time.time()))
    payload.setdefault("exp", int(time.time() + ttl))
    body = _b64(json.dumps(payload, separators=(",", ":")).encode())
    signing_input = f"{_HEADER}.{body}".encode()
    sig = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    return f"{_HEADER}.{body}.{_b64(sig)}"


def verify_token(token: str, secret: str) -> dict[str, Any]:
    """Validate signature + expiry; returns the claims."""
    parts = token.split(".")
    if len(parts) != 3:
        raise TokenError("malformed token")
    header_b64, body_b64, sig_b64 = parts
    try:
        header = json.loads(_unb64(header_b64))
    except Exception as e:
        raise TokenError("bad header") from e
    if header.get("alg") != "HS256":
        raise TokenError(f"unsupported alg {header.get('alg')!r}")
    signing_input = f"{header_b64}.{body_b64}".encode()
    want = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    if not hmac.compare_digest(want, _unb64(sig_b64)):
        raise TokenError("bad signature")
    try:
        claims = json.loads(_unb64(body_b64))
    except Exception as e:
        raise TokenError("bad payload") from e
    exp = claims.get("exp")
    if exp is not None and time.time() > float(exp):
        raise TokenError("token expired")
    return claims
