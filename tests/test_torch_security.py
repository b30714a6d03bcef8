"""The port's security/ (tokens, RBAC, the CA's issuance over RPC, mutual
TLS on the RPC core) against the reference's.

- A token signed by either package verifies in the other, and the two sign
  the same claims to the same bytes; a tampered, expired, malformed or
  ``alg: none`` token raises ``TokenError`` in both.
- The two ``Rbac`` answer alike for every role, resource and action, before
  and after ``add_policy``, and map every HTTP method to the same action.
- ``issue_certificate`` over RPC, across the two packages' managers and
  clients: with the bootstrap token a leaf the other package's CA chain
  verifies; a wrong or missing token is ``permission_denied``; a manager
  with a CA but no ``--cert-token`` refuses outright.
- A mutual-TLS RPC round trip with either package's client against either
  package's server, the leaves issued by either package's CA; the live
  connection reports its suite (``tls_info``); a client with no certificate
  is refused.

Every coroutine runs under a deadline of 120 s.
"""

from __future__ import annotations

import asyncio
import base64
import json
import ssl

import pytest
import torch

from dragonfly2_tpu import security as ref_security
from dragonfly2_tpu.manager.server import ManagerServer as RefManagerServer
from dragonfly2_tpu.rpc import core as ref_core
from dragonfly2_tpu.rpc.manager import RemoteManagerClient as RefRemoteManagerClient
from dragonfly2_tpu.security import ca as ref_ca
from dragonfly2_tpu.security import rbac as ref_rbac
from dragonfly2_tpu_torch import security
from dragonfly2_tpu_torch.manager.server import ManagerServer
from dragonfly2_tpu_torch.rpc import core as port_core
from dragonfly2_tpu_torch.rpc.manager import RemoteManagerClient
from dragonfly2_tpu_torch.security import ca as port_ca
from dragonfly2_tpu_torch.security import rbac as port_rbac

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools (see tests/test_torch_evaluator.py).
torch.set_num_threads(1)

DEADLINE_S = 120.0
PKGS = {"port": security, "ref": ref_security}
CA = {"port": port_ca, "ref": ref_ca}
CORE = {"port": port_core, "ref": ref_core}
MANAGER = {"port": (ManagerServer, RemoteManagerClient), "ref": (RefManagerServer, RefRemoteManagerClient)}


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


# ---------------------------------------------------------------------------
# tokens


@pytest.mark.parametrize("signer,verifier", [("port", "ref"), ("ref", "port"), ("port", "port")])
def test_a_token_signed_by_either_package_verifies_in_the_other(signer, verifier):
    tok = PKGS[signer].sign_token({"sub": "alice", "role": "admin"}, "s3cret")
    claims = PKGS[verifier].verify_token(tok, "s3cret")
    assert claims["sub"] == "alice" and claims["role"] == "admin"
    assert claims["exp"] > claims["iat"]


def test_both_packages_sign_the_same_claims_to_the_same_bytes():
    claims = {"sub": "bob", "role": "guest", "iat": 1_700_000_000, "exp": 1_800_000_000}
    assert security.sign_token(claims, "k") == ref_security.sign_token(claims, "k")


def _alg_none() -> str:
    header = base64.urlsafe_b64encode(json.dumps({"alg": "none"}).encode()).rstrip(b"=").decode()
    body = base64.urlsafe_b64encode(json.dumps({"sub": "x"}).encode()).rstrip(b"=").decode()
    return f"{header}.{body}."


@pytest.mark.parametrize("case", ["wrong-secret", "tampered", "expired", "malformed", "alg-none"])
@pytest.mark.parametrize("signer", ["port", "ref"])
def test_a_bad_token_raises_in_both(signer, case):
    sign = PKGS[signer].sign_token
    tok = {
        "wrong-secret": lambda: sign({"sub": "a"}, "secret-a"),
        "tampered": lambda: (lambda t: t[0] + "." + base64.urlsafe_b64encode(
            json.dumps({"sub": "root", "role": "admin", "exp": 4_000_000_000}).encode()).rstrip(b"=").decode()
            + "." + t[2])(sign({"sub": "a"}, "s").split(".")),
        "expired": lambda: sign({"sub": "a"}, "s", ttl=-10),
        "malformed": lambda: "garbage.token",
        "alg-none": _alg_none,
    }[case]()
    secret = "secret-b" if case == "wrong-secret" else "s"
    for pkg in ("port", "ref"):
        with pytest.raises(PKGS[pkg].TokenError):
            PKGS[pkg].verify_token(tok, secret)


# ---------------------------------------------------------------------------
# RBAC


ACTIONS = ("read", "write", "delete")
ROLES = sorted(set(port_rbac.ROLES) | {"nobody", "ml-bot"})
RESOURCES = sorted({r for perms in port_rbac.ROLES.values() for r in perms} | {"unknown"})


def test_the_role_tables_are_the_references():
    assert port_rbac.ROLES == ref_rbac.ROLES


@pytest.mark.parametrize("role", ROLES)
def test_both_rbacs_answer_alike_for_every_resource_and_action(role):
    port, ref = security.Rbac(), ref_security.Rbac()
    for r in (port, ref):
        r.add_policy("ml-bot", "models", ["read", "write"])
    for resource in RESOURCES:
        for action in ACTIONS:
            assert port.allowed(role, resource, action) == ref.allowed(role, resource, action), (resource, action)
    for method in ("GET", "HEAD", "OPTIONS", "POST", "PUT", "PATCH", "DELETE", "get"):
        assert security.Rbac.action_for_method(method) == ref_security.Rbac.action_for_method(method)


# ---------------------------------------------------------------------------
# issuance over RPC


def _verifies(leaf_pem: str, ca_pem: str, tmp_path) -> None:
    """The leaf's chain, checked by a TLS handshake: a server holding the
    leaf, a client trusting only the CA."""
    import socket
    import threading

    leaf, key, root = tmp_path / "leaf.pem", tmp_path / "leaf.key", tmp_path / "root.pem"
    root.write_text(ca_pem)
    leaf.write_text(leaf_pem)
    srv = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    srv.load_cert_chain(str(leaf), str(key))
    cli = ssl.create_default_context(cafile=str(root))
    ls = socket.create_server(("127.0.0.1", 0))
    port = ls.getsockname()[1]

    def serve():
        conn, _ = ls.accept()
        with srv.wrap_socket(conn, server_side=True) as s:
            s.recv(1)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    with socket.create_connection(("127.0.0.1", port)) as raw, \
            cli.wrap_socket(raw, server_hostname="127.0.0.1") as s:
        s.send(b"x")
    t.join(10)
    ls.close()
    assert not t.is_alive()


@pytest.mark.parametrize("client_pkg", ["port", "ref"])
@pytest.mark.parametrize("server_pkg", ["port", "ref"])
def test_certificate_issuance_over_rpc_across_the_packages(server_pkg, client_pkg, tmp_path):
    server_cls, _ = MANAGER[server_pkg]
    _, client_cls = MANAGER[client_pkg]
    codes = {"port": port_core.RpcError, "ref": ref_core.RpcError}

    async def body():
        server = server_cls(db_path=":memory:", port=0, rest_port=None, ca_dir=str(tmp_path / "ca"),
                            admin_password="boot", cert_token="bootstrap-secret")
        await server.start()
        client = client_cls(server.address, retries=0)
        try:
            out = await client.issue_certificate("daemon-7", sans=["127.0.0.1"], token="bootstrap-secret")
            refused = []
            for token in ("wrong", ""):
                with pytest.raises(codes[client_pkg]) as e:
                    await client.issue_certificate("evil", token=token)
                refused.append(e.value.code)
            return out, refused
        finally:
            await client.close()
            await server.stop()

    out, refused = run(body())
    assert "BEGIN CERTIFICATE" in out["cert_pem"] and "PRIVATE KEY" in out["key_pem"]
    assert refused == ["permission_denied", "permission_denied"]
    (tmp_path / "leaf.key").write_text(out["key_pem"])
    _verifies(out["cert_pem"], out["ca_pem"], tmp_path)
    # the other package's CA object, loaded from the same directory, holds the same root
    other = CA["ref" if server_pkg == "port" else "port"].CertificateAuthority(tmp_path / "ca")
    assert other.ca_pem.decode() == out["ca_pem"]


@pytest.mark.parametrize("client_pkg", ["port", "ref"])
@pytest.mark.parametrize("server_pkg", ["port", "ref"])
def test_issuance_is_refused_without_a_cert_token(server_pkg, client_pkg, tmp_path):
    server_cls, _ = MANAGER[server_pkg]
    _, client_cls = MANAGER[client_pkg]

    async def body():
        server = server_cls(db_path=":memory:", port=0, rest_port=None, ca_dir=str(tmp_path / "ca"))
        await server.start()
        client = client_cls(server.address, retries=0)
        try:
            with pytest.raises(Exception) as e:
                await client.issue_certificate("daemon-7", token="anything")
            return e.value.code
        finally:
            await client.close()
            await server.stop()

    assert run(body()) == "permission_denied"


# ---------------------------------------------------------------------------
# mutual TLS on the RPC core


@pytest.mark.parametrize("ca_pkg", ["port", "ref"])
@pytest.mark.parametrize("client_pkg", ["port", "ref"])
@pytest.mark.parametrize("server_pkg", ["port", "ref"])
def test_mtls_rpc_round_trip_across_the_packages(server_pkg, client_pkg, ca_pkg, tmp_path):
    ca = CA[ca_pkg].CertificateAuthority(tmp_path / "ca")
    srv_paths = CA[ca_pkg].write_issued(ca.issue("server", sans=["127.0.0.1"]), tmp_path / "srv")
    cli_paths = CA[ca_pkg].write_issued(ca.issue("client", sans=["127.0.0.1"]), tmp_path / "cli")
    server_core, client_core = CORE[server_pkg], CORE[client_pkg]
    # each side's context from its own package's helpers
    srv_ctx = CA[server_pkg].server_ssl_context(srv_paths["cert"], srv_paths["key"], srv_paths["ca"])
    cli_ctx = CA[client_pkg].client_ssl_context(cli_paths["ca"], cli_paths["cert"], cli_paths["key"])
    bare_ctx = CA[client_pkg].client_ssl_context(cli_paths["ca"])

    async def body():
        server = server_core.RpcServer(host="127.0.0.1", ssl=srv_ctx)

        async def echo(p):
            return {"echo": p}

        server.register("echo", echo)
        await server.start()
        try:
            client = client_core.RpcClient(f"127.0.0.1:{server.port}", ssl=cli_ctx, retries=0)
            out = await client.call("echo", {"x": 1, "b": b"\x00\x01"})
            info = client.tls_info()
            await client.close()
            closed = client.tls_info()
            bare = client_core.RpcClient(f"127.0.0.1:{server.port}", ssl=bare_ctx, retries=0, timeout=5.0)
            try:
                with pytest.raises(Exception):
                    await bare.call("echo", {})
            finally:
                await bare.close()
            return out, info, closed
        finally:
            await server.stop()

    out, info, closed = run(body())
    assert out == {"echo": {"x": 1, "b": b"\x00\x01"}}
    assert info is not None and info["cipher"] and info["version"]
    assert closed is None
