"""Cluster security, the port of dragonfly2_tpu/security/: the CA and leaf
issuance (``ca.py``, both backends), HTTPS interception (``mitm.py``: the
leaf forger and the ClientHello SNI parser) and the plain data-plane
transport (``transport.AsyncPlainTransport``). The mTLS data plane, RBAC and
tokens are still to port (ROADMAP.md §1, 'Still to do' item 4)."""

from dragonfly2_tpu_torch.security.ca import (
    CertificateAuthority,
    IssuedCert,
    client_ssl_context,
    server_ssl_context,
    write_issued,
)
from dragonfly2_tpu_torch.security.mitm import CertForger, parse_client_hello_sni

__all__ = [
    "CertForger",
    "CertificateAuthority",
    "IssuedCert",
    "client_ssl_context",
    "parse_client_hello_sni",
    "server_ssl_context",
    "write_issued",
]
