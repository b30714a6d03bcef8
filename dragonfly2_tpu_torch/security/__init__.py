"""The port's security package: so far only the plain data-plane transport
(``transport.AsyncPlainTransport``). The CA, the mTLS data plane, mitm,
RBAC and tokens are still to port (ROADMAP.md §1, 'Still to do' item 4)."""
