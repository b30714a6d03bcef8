"""Self-signed CA + leaf certificate issuance (ref pkg/issuer/issuer.go
NewDragonflyIssuer + manager-side security service): the port of
dragonfly2_tpu/security/ca.py. A CA directory made by either package
loads in the other, and their leaves verify under each other's CA.

EC P-256 keys, CA persisted to a directory (ca.pem/ca.key), leaf certs issued
with IP/DNS SANs and bounded validity. Services call the manager's
issue_certificate RPC at boot and cache the result on disk (the reference
uses certify's cache for the same reason: restart without re-issuance).

Two interchangeable issuance backends behind one `CertificateAuthority`
facade: the `cryptography` package when importable, else the `openssl` CLI
(a host may ship an openssl binary but not the cryptography wheel, and the
mTLS plane must not depend on an installable extra). Both persist the same
ca.pem/ca.key PEM pair, so a directory created by one backend loads under the
other."""

from __future__ import annotations

import ipaddress
import logging
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Optional

try:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    _HAVE_CRYPTOGRAPHY = True
except ImportError:  # gated, not required: the CLI backend below covers it
    _HAVE_CRYPTOGRAPHY = False

logger = logging.getLogger(__name__)

DEFAULT_CA_DAYS = 10 * 365
DEFAULT_LEAF_DAYS = 30

_ORG = "dragonfly2-tpu"


@dataclass
class IssuedCert:
    cert_pem: bytes
    key_pem: bytes
    ca_pem: bytes

    def to_dict(self) -> dict:
        """Wire form shared by the REST and RPC issuance planes."""
        return {
            "cert_pem": self.cert_pem.decode(),
            "key_pem": self.key_pem.decode(),
            "ca_pem": self.ca_pem.decode(),
        }


def _split_sans(sans: Iterable[str]) -> tuple[list[str], list[str]]:
    """(ips, dns_names) — entries auto-detected like the reference issuer."""
    ips: list[str] = []
    dns: list[str] = []
    for s in sans:
        try:
            ipaddress.ip_address(s)
            ips.append(s)
        except ValueError:
            dns.append(s)
    return ips, dns


class _CryptographyBackend:
    """Issuance via the `cryptography` package (original implementation)."""

    def __init__(self, cert_path: Path, key_path: Path, common_name: str):
        self._cert_path = cert_path
        self._key_path = key_path
        if cert_path.exists() and key_path.exists():
            self._cert = x509.load_pem_x509_certificate(cert_path.read_bytes())
            self._key = serialization.load_pem_private_key(
                key_path.read_bytes(), password=None
            )
            logger.info("loaded CA from %s", cert_path.parent)
        else:
            import datetime

            self._key = ec.generate_private_key(ec.SECP256R1())
            now = datetime.datetime.now(datetime.timezone.utc)
            name = self._name(common_name)
            self._cert = (
                x509.CertificateBuilder()
                .subject_name(name)
                .issuer_name(name)
                .public_key(self._key.public_key())
                .serial_number(x509.random_serial_number())
                .not_valid_before(now - datetime.timedelta(minutes=5))
                .not_valid_after(now + datetime.timedelta(days=DEFAULT_CA_DAYS))
                .add_extension(x509.BasicConstraints(ca=True, path_length=0), critical=True)
                .add_extension(
                    x509.KeyUsage(
                        digital_signature=True, key_cert_sign=True, crl_sign=True,
                        content_commitment=False, key_encipherment=False,
                        data_encipherment=False, key_agreement=False,
                        encipher_only=False, decipher_only=False,
                    ),
                    critical=True,
                )
                .sign(self._key, hashes.SHA256())
            )
            cert_path.write_bytes(self._cert.public_bytes(serialization.Encoding.PEM))
            key_path.write_bytes(self._key_pem(self._key))
            key_path.chmod(0o600)
            logger.info("created new CA at %s", cert_path.parent)

    @staticmethod
    def _name(common_name: str) -> "x509.Name":
        return x509.Name(
            [
                x509.NameAttribute(NameOID.ORGANIZATION_NAME, _ORG),
                x509.NameAttribute(NameOID.COMMON_NAME, common_name),
            ]
        )

    @staticmethod
    def _key_pem(key: "ec.EllipticCurvePrivateKey") -> bytes:
        return key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        )

    @property
    def ca_pem(self) -> bytes:
        return self._cert.public_bytes(serialization.Encoding.PEM)

    def issue(
        self, common_name: str, *, sans: Iterable[str], days: int,
        server: bool, client: bool,
    ) -> IssuedCert:
        import datetime

        key = ec.generate_private_key(ec.SECP256R1())
        now = datetime.datetime.now(datetime.timezone.utc)
        san_objs: list[x509.GeneralName] = []
        for s in sans:
            try:
                san_objs.append(x509.IPAddress(ipaddress.ip_address(s)))
            except ValueError:
                san_objs.append(x509.DNSName(s))
        if not san_objs:
            san_objs = [x509.DNSName(common_name)]
        ekus = []
        if server:
            ekus.append(x509.oid.ExtendedKeyUsageOID.SERVER_AUTH)
        if client:
            ekus.append(x509.oid.ExtendedKeyUsageOID.CLIENT_AUTH)
        cert = (
            x509.CertificateBuilder()
            .subject_name(self._name(common_name))
            .issuer_name(self._cert.subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=days))
            .add_extension(x509.BasicConstraints(ca=False, path_length=None), critical=True)
            .add_extension(x509.SubjectAlternativeName(san_objs), critical=False)
            .add_extension(x509.ExtendedKeyUsage(ekus), critical=False)
            .sign(self._key, hashes.SHA256())
        )
        return IssuedCert(
            cert_pem=cert.public_bytes(serialization.Encoding.PEM),
            key_pem=self._key_pem(key),
            ca_pem=self.ca_pem,
        )


class _OpensslCliBackend:
    """Issuance by shelling out to the `openssl` binary (>= 1.1.1 for
    `req -addext`). Same artifacts as the cryptography backend: P-256 PKCS8
    keys, a pathlen:0 CA, leaf certs with SANs + EKUs. Issuance is a boot-time
    RPC, not a hot path — three subprocesses per cert is fine."""

    def __init__(self, cert_path: Path, key_path: Path, common_name: str):
        self._cert_path = cert_path
        self._key_path = key_path
        if cert_path.exists() and key_path.exists():
            logger.info("loaded CA from %s", cert_path.parent)
            return
        self._gen_key(key_path)
        key_path.chmod(0o600)
        with tempfile.TemporaryDirectory(prefix="df-ca-") as td:
            # explicit config, not -addext: `req -x509` otherwise ALSO emits
            # its default basicConstraints=CA:TRUE, and a certificate with
            # duplicate extensions fails chain building (verify error 20)
            cnf = Path(td) / "ca.cnf"
            cnf.write_text(
                "[req]\n"
                "distinguished_name = dn\n"
                "x509_extensions = v3_ca\n"
                "prompt = no\n"
                "[dn]\n"
                f"O = {_ORG}\n"
                f"CN = {common_name}\n"
                "[v3_ca]\n"
                "basicConstraints = critical,CA:TRUE,pathlen:0\n"
                "keyUsage = critical,digitalSignature,keyCertSign,cRLSign\n"
                "subjectKeyIdentifier = hash\n"
            )
            self._run(
                "req", "-x509", "-new", "-key", str(key_path), "-sha256",
                "-days", str(DEFAULT_CA_DAYS), "-config", str(cnf),
                "-out", str(cert_path),
            )
        logger.info("created new CA at %s (openssl CLI backend)", cert_path.parent)

    @staticmethod
    def _run(*args: str) -> None:
        proc = subprocess.run(
            ["openssl", *args], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"openssl {args[0]} failed ({proc.returncode}): {proc.stderr.strip()}"
            )

    @staticmethod
    def _gen_key(out_path: Path) -> None:
        _OpensslCliBackend._run(
            "genpkey", "-algorithm", "EC",
            "-pkeyopt", "ec_paramgen_curve:P-256", "-out", str(out_path),
        )

    @staticmethod
    def _subj(common_name: str) -> str:
        # '/' delimits RDNs in -subj; service names never legitimately carry it
        return f"/O={_ORG}/CN={common_name.replace('/', '_')}"

    @property
    def ca_pem(self) -> bytes:
        return self._cert_path.read_bytes()

    def issue(
        self, common_name: str, *, sans: Iterable[str], days: int,
        server: bool, client: bool,
    ) -> IssuedCert:
        import secrets

        ips, dns = _split_sans(sans)
        if not ips and not dns:
            dns = [common_name]
        san_line = ",".join(
            [f"IP:{ip}" for ip in ips] + [f"DNS:{d}" for d in dns]
        )
        ekus = [eku for eku, on in (("serverAuth", server), ("clientAuth", client)) if on]
        with tempfile.TemporaryDirectory(prefix="df-issue-") as td:
            t = Path(td)
            key, csr, crt, ext = t / "leaf.key", t / "leaf.csr", t / "leaf.crt", t / "ext.cnf"
            self._gen_key(key)
            self._run(
                "req", "-new", "-key", str(key),
                "-subj", self._subj(common_name), "-out", str(csr),
            )
            lines = [f"basicConstraints = critical,CA:FALSE", f"subjectAltName = {san_line}"]
            if ekus:
                lines.append(f"extendedKeyUsage = {','.join(ekus)}")
            ext.write_text("\n".join(lines) + "\n")
            self._run(
                "x509", "-req", "-in", str(csr), "-sha256", "-days", str(days),
                "-CA", str(self._cert_path), "-CAkey", str(self._key_path),
                # explicit random serial: no ca.srl state file in the CA dir
                "-set_serial", str(secrets.randbits(63)),
                "-extfile", str(ext), "-out", str(crt),
            )
            return IssuedCert(
                cert_pem=crt.read_bytes(), key_pem=key.read_bytes(), ca_pem=self.ca_pem
            )


class CertificateAuthority:
    """Filesystem-backed CA: loads ca.pem/ca.key from `directory` or creates
    a fresh self-signed pair on first use. ``backend`` names the issuance
    backend in use: "cryptography" or "openssl-cli"."""

    def __init__(self, directory: str | Path, *, common_name: str = "dragonfly2-tpu-ca"):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._cert_path = self.dir / "ca.pem"
        self._key_path = self.dir / "ca.key"
        if _HAVE_CRYPTOGRAPHY:
            self._impl = _CryptographyBackend(self._cert_path, self._key_path, common_name)
            self.backend = "cryptography"
        elif shutil.which("openssl"):
            self._impl = _OpensslCliBackend(self._cert_path, self._key_path, common_name)
            self.backend = "openssl-cli"
        else:
            raise RuntimeError(
                "certificate issuance needs either the `cryptography` package "
                "or an `openssl` binary on PATH; neither is available"
            )

    @property
    def ca_pem(self) -> bytes:
        return self._impl.ca_pem

    def issue(
        self,
        common_name: str,
        *,
        sans: Iterable[str] = (),
        days: int = DEFAULT_LEAF_DAYS,
        server: bool = True,
        client: bool = True,
    ) -> IssuedCert:
        """Issue a leaf cert. sans entries are IPs or DNS names (auto-detected).
        Both serverAuth and clientAuth by default — every service is both in a
        mesh (ref issues one cert per service instance)."""
        return self._impl.issue(
            common_name, sans=sans, days=days, server=server, client=client
        )


def write_issued(cert: IssuedCert, directory: str | Path, *, prefix: str = "tls") -> dict:
    """Cache an issued cert to disk (certify-cache equivalent); returns paths."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    paths = {
        "cert": d / f"{prefix}.crt",
        "key": d / f"{prefix}.key",
        "ca": d / "ca.pem",
    }
    paths["cert"].write_bytes(cert.cert_pem)
    paths["key"].write_bytes(cert.key_pem)
    paths["key"].chmod(0o600)
    paths["ca"].write_bytes(cert.ca_pem)
    return {k: str(v) for k, v in paths.items()}


def server_ssl_context(cert_path: str, key_path: str, ca_path: Optional[str] = None):
    """ssl.SSLContext for a TLS server; with ca_path, client certs are
    required (mTLS force policy)."""
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_path, key_path)
    if ca_path:
        ctx.load_verify_locations(ca_path)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_ssl_context(
    ca_path: str, cert_path: Optional[str] = None, key_path: Optional[str] = None
):
    """ssl.SSLContext for a TLS client pinned to the cluster CA; with a
    cert/key pair the client authenticates too (mTLS)."""
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(ca_path)
    ctx.check_hostname = False  # cluster certs are SAN-per-IP; ips move
    ctx.verify_mode = ssl.CERT_REQUIRED
    if cert_path and key_path:
        ctx.load_cert_chain(cert_path, key_path)
    return ctx
