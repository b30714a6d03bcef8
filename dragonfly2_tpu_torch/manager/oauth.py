"""OAuth2 authorization-code sign-in for the manager.

Parity with reference manager/handlers/oauth.go + models/oauth.go: CRUD of
OAuth provider configs (name, client id/secret, endpoints, scopes) and the
code flow — redirect the browser to the provider's auth URL with a signed
state, then exchange the callback code for an access token, fetch the user
identity, upsert a manager user, and issue the same JWT password sign-in
issues. Providers are generic (any spec-compliant authorization server);
the reference hardcodes google/github shapes, this keeps the endpoints in
the provider row instead.

The port of dragonfly2_tpu/manager/oauth.py.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import time
from typing import Any
from urllib.parse import urlencode

import aiohttp


class OauthError(Exception):
    pass


_STATE_TTL_S = 600.0


class StateStore:
    """Signed, provider-bound, SINGLE-USE OAuth states.

    The signature proves the manager minted the state for THIS provider;
    consuming the nonce on first verification blocks replay. Residual login
    CSRF (an attacker relaying their own fresh state+code into a victim's
    browser) can only be closed by binding states to a browser session
    cookie — the manager's console layer owns cookies, so that binding lives
    there; this store is the server-side floor under it."""

    def __init__(self, secret: str):
        self._secret = secret.encode()
        self._pending: dict[str, float] = {}  # nonce -> expiry

    def _mac(self, nonce: str, ts: str, provider: str) -> str:
        msg = f"{nonce}.{ts}.{provider}".encode()
        return hmac.new(self._secret, msg, hashlib.sha256).hexdigest()[:32]

    def mint(self, provider: str) -> str:
        now = time.time()
        # purge expired pending states so the dict can't grow unboundedly
        self._pending = {n: e for n, e in self._pending.items() if e > now}
        nonce = os.urandom(12).hex()
        ts = str(int(now))
        self._pending[nonce] = now + _STATE_TTL_S
        return f"{nonce}.{ts}.{self._mac(nonce, ts, provider)}"

    def consume(self, state: str, provider: str) -> bool:
        try:
            nonce, ts, mac = state.split(".")
        except ValueError:
            return False
        if not hmac.compare_digest(mac, self._mac(nonce, ts, provider)):
            return False
        expiry = self._pending.pop(nonce, None)  # single use
        return expiry is not None and expiry > time.time()


def authorize_url(provider: dict[str, Any], state: str) -> str:
    """The provider redirect target for the browser (code flow step 1)."""
    params = {
        "response_type": "code",
        "client_id": provider["client_id"],
        "state": state,
    }
    if provider.get("redirect_url"):
        params["redirect_uri"] = provider["redirect_url"]
    scopes = provider.get("scopes") or []
    if scopes:
        params["scope"] = " ".join(scopes)
    sep = "&" if "?" in provider["auth_url"] else "?"
    return provider["auth_url"] + sep + urlencode(params)


async def exchange_code(
    provider: dict[str, Any], code: str, *, session: aiohttp.ClientSession | None = None
) -> str:
    """Code → access token at the provider's token endpoint (step 2)."""
    data = {
        "grant_type": "authorization_code",
        "code": code,
        "client_id": provider["client_id"],
        "client_secret": provider["client_secret"],
    }
    if provider.get("redirect_url"):
        data["redirect_uri"] = provider["redirect_url"]
    owns = session is None
    sess = session or aiohttp.ClientSession()
    try:
        async with sess.post(
            provider["token_url"], data=data, headers={"Accept": "application/json"}
        ) as resp:
            if resp.status >= 400:
                raise OauthError(f"token exchange failed: HTTP {resp.status}")
            body = await resp.json(content_type=None)
    finally:
        if owns:
            await sess.close()
    token = body.get("access_token", "")
    if not token:
        raise OauthError(f"provider returned no access_token: {body.get('error', '')}")
    return token


async def fetch_identity(
    provider: dict[str, Any], access_token: str, *, session: aiohttp.ClientSession | None = None
) -> dict[str, str]:
    """Access token → {name, email} from the provider's user-info endpoint."""
    url = provider.get("user_info_url", "")
    if not url:
        raise OauthError(f"provider {provider['name']!r} has no user_info_url")
    owns = session is None
    sess = session or aiohttp.ClientSession()
    try:
        async with sess.get(url, headers={"Authorization": f"Bearer {access_token}"}) as resp:
            if resp.status >= 400:
                raise OauthError(f"user info fetch failed: HTTP {resp.status}")
            body = await resp.json(content_type=None)
    finally:
        if owns:
            await sess.close()
    name = body.get("login") or body.get("name") or body.get("email") or ""
    if not name:
        raise OauthError("provider user info had no usable identity")
    return {"name": str(name), "email": str(body.get("email", ""))}
