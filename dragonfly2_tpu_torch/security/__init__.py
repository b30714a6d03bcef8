"""Cluster security, the port of dragonfly2_tpu/security/: the CA and leaf
issuance (``ca.py``, both backends), HTTPS interception (``mitm.py``: the
leaf forger and the ClientHello SNI parser), the data-plane transports and
mTLS contexts (``transport.py``), HMAC tokens (``tokens.py``) and the
manager's table-driven RBAC (``rbac.py``). Exports what the reference's
``security/__init__`` exports, and the port's ca/mitm names beside them."""

from dragonfly2_tpu_torch.security.ca import (
    CertificateAuthority,
    IssuedCert,
    client_ssl_context,
    server_ssl_context,
    write_issued,
)
from dragonfly2_tpu_torch.security.mitm import CertForger, parse_client_hello_sni
from dragonfly2_tpu_torch.security.rbac import ROLES, Rbac
from dragonfly2_tpu_torch.security.tokens import TokenError, sign_token, verify_token

__all__ = [
    "CertForger",
    "CertificateAuthority",
    "IssuedCert",
    "ROLES",
    "Rbac",
    "TokenError",
    "client_ssl_context",
    "parse_client_hello_sni",
    "server_ssl_context",
    "sign_token",
    "verify_token",
    "write_issued",
]
