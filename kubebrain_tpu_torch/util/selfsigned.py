"""Self-signed certificate generation shared by TLS tests and benches.

The reference keeps test certs as checked-in fixtures plus a gen-certs.sh
(pkg/util/auth/testdata); here they are generated on demand so nothing
secret lives in the tree.
"""

from __future__ import annotations

import datetime
import ipaddress
import os


def gen_self_signed(
    directory: str,
    common_name: str = "kubebrain-tpu",
    dns_names: tuple[str, ...] = ("localhost",),
    ip_addresses: tuple[str, ...] = ("127.0.0.1",),
) -> tuple[str, str]:
    """Write server.crt / server.key (PEM, unencrypted) into ``directory``
    and return their paths. RSA-2048, 1-day validity."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    sans = [x509.DNSName(d) for d in dns_names] + [
        x509.IPAddress(ipaddress.ip_address(ip)) for ip in ip_addresses
    ]
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=1))
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .sign(key, hashes.SHA256())
    )
    cert_file = os.path.join(directory, "server.crt")
    key_file = os.path.join(directory, "server.key")
    with open(cert_file, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    with open(key_file, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption(),
        ))
    return cert_file, key_file
