"""Public-key crypto layer: identities, signatures, hybrid encryption, x509.

Behavioral port of the reference crypto wrappers (reference:
include/opendht/crypto.h:67-496, src/crypto.cpp) on top of the
``cryptography`` package instead of GnuTLS/nettle:

- ``PrivateKey`` — RSA (default 4096) or EC (SECP521R1 = GnuTLS
  SEC_PARAM_ULTRA, src/crypto.cpp:885-896); ``sign`` = SHA512 signature
  (PKCS#1 v1.5 for RSA, DER ECDSA for EC; src/crypto.cpp:307-321);
  ``decrypt`` undoes the hybrid scheme below (src/crypto.cpp:336-356).
- ``PublicKey`` — ``check_signature``; ``encrypt``: plain RSA PKCS#1 v1.5
  when the data fits one block (≤ keylen/8 − 11), else hybrid
  [RSA(random AES key)][AES-GCM(data)] using the largest AES key that
  fits (src/crypto.cpp:478-543); ``get_id()`` = SHA1 of the DER
  SubjectPublicKeyInfo (the fingerprint the whole DHT keys on).
- ``Certificate`` — x509 chain (cert + issuers), packed as concatenated
  DER like the reference's getPacked chains (src/crypto.cpp:573-600);
  ``generate`` mirrors Certificate::generate (src/crypto.cpp:925-995):
  10-year validity, CN=name, UID=key id hex, random 64-bit serial,
  subject-key-id = key id, CA flags.
- ``RevocationList`` — x509 CRL (src/crypto.cpp:1005-1125).
- ``TrustList`` — trusted-root store with chain + revocation verification
  (crypto.h:468-496).
- ``aes_encrypt/aes_decrypt`` — AES-GCM, layout IV(12)‖ciphertext‖tag(16)
  (src/crypto.cpp:119-191); password variants prefix a 16-byte salt.
- ``stretch_key`` — password KDF: argon2i(t=16, m=64MiB, p=1) → 32 bytes
  → length-selected digest, exactly the reference's stretchKey
  (src/crypto.cpp:193-206), via argon2-cffi (the official phc-winner
  C implementation).  Earlier builds used scrypt(n=2^15, r=8, p=1) as a
  stand-in; ``aes_decrypt_password`` still falls back to the scrypt key
  so blobs written by those builds remain readable (legacy path,
  local storage only — never the wire format).

``Identity = (PrivateKey, Certificate)`` as in crypto.h:62.

A copy of the JAX package's ``crypto.py`` with its behaviour unchanged.
It imports ``cryptography`` and ``argon2`` when it is itself imported,
so the rest of the port reaches it only through
``utils.lazy_module("opendht_tpu_torch.crypto")``: an identity-less
node runs without either wheel.
"""

from __future__ import annotations

import datetime
import secrets
from typing import Optional

from cryptography import x509
from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec, padding, rsa
from cryptography.hazmat.primitives.ciphers.aead import AESGCM
from cryptography.x509.oid import ExtensionOID, NameOID
import hashlib

from argon2.low_level import hash_secret_raw as _argon2_raw
from argon2.low_level import Type as _Argon2Type

from .infohash import InfoHash, PkId, _digest_for_len
from .utils import DhtException


class CryptoException(DhtException):
    pass


class DecryptError(CryptoException):
    pass


# ------------------------------------------------------------------ symmetric

GCM_IV_SIZE = 12
GCM_DIGEST_SIZE = 16
PASSWORD_SALT_LENGTH = 16
AES_LENGTHS = (128 // 8, 192 // 8, 256 // 8)


def aes_key_size(max_size: int) -> int:
    """Largest AES key length ≤ max_size (src/crypto.cpp:95-105)."""
    best = 0
    for s in AES_LENGTHS:
        if s <= max_size:
            best = s
        else:
            break
    return best


def aes_key_size_good(n: int) -> bool:
    return n in AES_LENGTHS


def aes_encrypt(data: bytes, key: bytes) -> bytes:
    """IV(12) ‖ ciphertext ‖ tag(16)  (src/crypto.cpp:119-137)."""
    if not aes_key_size_good(len(key)):
        raise DecryptError("Wrong key size")
    iv = secrets.token_bytes(GCM_IV_SIZE)
    # AESGCM.encrypt returns ciphertext‖tag, exactly the reference layout
    return iv + AESGCM(key).encrypt(iv, bytes(data), None)


def aes_decrypt(data: bytes, key: bytes) -> bytes:
    if not aes_key_size_good(len(key)):
        raise DecryptError("Wrong key size")
    if len(data) <= GCM_IV_SIZE + GCM_DIGEST_SIZE:
        raise DecryptError("Wrong data size")
    try:
        return AESGCM(key).decrypt(data[:GCM_IV_SIZE], data[GCM_IV_SIZE:], None)
    except Exception as e:
        raise DecryptError("Can't decrypt data") from e


def stretch_key(password: str, salt: Optional[bytes], key_length: int = 32):
    """Password → key.  Returns (key, salt).

    argon2i(t=16, m=64MiB, p=1, out=32) then the length-selected digest,
    byte-compatible with the reference stretchKey
    (src/crypto.cpp:193-206: argon2i_hash_raw(16, 64*1024, 1, ...) then
    hash(res, key_length))."""
    if not salt:
        salt = secrets.token_bytes(PASSWORD_SALT_LENGTH)
    raw = _argon2_raw(password.encode(), salt, time_cost=16,
                      memory_cost=64 * 1024, parallelism=1, hash_len=32,
                      type=_Argon2Type.I)
    return _digest_for_len(raw, key_length), salt


def _stretch_key_scrypt(password: str, salt: bytes, key_length: int = 32):
    """Legacy KDF (scrypt stand-in), kept so blobs written
    before the argon2i switch stay decryptable."""
    raw = hashlib.scrypt(password.encode(), salt=salt, n=2 ** 15, r=8, p=1,
                         maxmem=64 * 1024 * 1024, dklen=32)
    return _digest_for_len(raw, key_length)


def aes_encrypt_password(data: bytes, password: str) -> bytes:
    key, salt = stretch_key(password, None, 256 // 8)
    return salt + aes_encrypt(data, key)


def aes_decrypt_password(data: bytes, password: str) -> bytes:
    if len(data) <= PASSWORD_SALT_LENGTH:
        raise DecryptError("Wrong data size")
    salt = data[:PASSWORD_SALT_LENGTH]
    key, _ = stretch_key(password, salt, 256 // 8)
    try:
        return aes_decrypt(data[PASSWORD_SALT_LENGTH:], key)
    except DecryptError:
        # legacy: blob may have been written by an earlier (scrypt) build
        key = _stretch_key_scrypt(password, salt, 256 // 8)
        return aes_decrypt(data[PASSWORD_SALT_LENGTH:], key)


def hash_data(data: bytes, hash_len: int = 64) -> bytes:
    """Digest selected by output length: ≤20 SHA1, ≤32 SHA256, else SHA512
    (src/crypto.cpp:208-227)."""
    return _digest_for_len(bytes(data), hash_len)


# ----------------------------------------------------------------- PublicKey


class PublicKey:
    """Verify + hybrid-encrypt wrapper (crypto.h:67-117).

    Satisfies the owner-key protocol expected by core.value
    (export_der / get_id / check_signature)."""

    __slots__ = ("_pk", "_der")

    def __init__(self, key_or_der):
        if isinstance(key_or_der, (bytes, bytearray, memoryview)):
            der = bytes(key_or_der)
            try:
                self._pk = serialization.load_der_public_key(der)
            except Exception:
                try:
                    self._pk = serialization.load_pem_public_key(der)
                except Exception as e:
                    raise CryptoException("Can't read public key") from e
        else:
            self._pk = key_or_der
        self._der = self._pk.public_bytes(
            serialization.Encoding.DER,
            serialization.PublicFormat.SubjectPublicKeyInfo)

    # -- identity
    def export_der(self) -> bytes:
        return self._der

    def export_pem(self) -> bytes:
        return self._pk.public_bytes(
            serialization.Encoding.PEM,
            serialization.PublicFormat.SubjectPublicKeyInfo)

    def get_id(self) -> InfoHash:
        """SHA1 fingerprint of the DER export (crypto.cpp:545-560)."""
        return InfoHash.get(self._der)

    def get_long_id(self) -> PkId:
        """SHA256 fingerprint (crypto.cpp:562-575)."""
        return PkId.get(self._der)

    # -- verify
    def check_signature(self, data: bytes, signature: bytes) -> bool:
        """SHA512 verify; scheme keyed by key type (crypto.cpp:466-477)."""
        try:
            if isinstance(self._pk, rsa.RSAPublicKey):
                self._pk.verify(bytes(signature), bytes(data),
                                padding.PKCS1v15(), hashes.SHA512())
            elif isinstance(self._pk, ec.EllipticCurvePublicKey):
                self._pk.verify(bytes(signature), bytes(data),
                                ec.ECDSA(hashes.SHA512()))
            else:
                return False
            return True
        except InvalidSignature:
            return False
        except Exception:
            return False

    # -- encrypt
    def encrypt(self, data: bytes) -> bytes:
        """Plain RSA block if it fits, else [RSA(aes key)][aes_encrypt(data)]
        (crypto.cpp:494-543)."""
        if not isinstance(self._pk, rsa.RSAPublicKey):
            raise CryptoException("Must be an RSA key")
        data = bytes(data)
        block = self._pk.key_size // 8
        max_block = block - 11
        if len(data) <= max_block:
            return self._pk.encrypt(data, padding.PKCS1v15())
        key_sz = aes_key_size(max_block)
        if key_sz == 0:
            raise CryptoException("Key is not long enough for AES128")
        key = secrets.token_bytes(key_sz)
        return self._pk.encrypt(key, padding.PKCS1v15()) + aes_encrypt(data, key)

    def __eq__(self, other):
        return (hasattr(other, "export_der")
                and self._der == other.export_der())

    def __hash__(self):
        return hash(self._der)

    def __repr__(self):
        return f"PublicKey({self.get_id()})"


# ---------------------------------------------------------------- PrivateKey


class PrivateKey:
    """RSA/EC private key (crypto.h:120-169)."""

    __slots__ = ("_sk",)

    def __init__(self, key_or_bytes, password: str = ""):
        if isinstance(key_or_bytes, (bytes, bytearray, memoryview)):
            raw = bytes(key_or_bytes)
            pw = password.encode() if password else None
            last = None
            for loader in (serialization.load_pem_private_key,
                           serialization.load_der_private_key):
                try:
                    self._sk = loader(raw, password=pw)
                    return
                except Exception as e:
                    last = e
            raise CryptoException(f"Can't load private key: {last}")
        else:
            self._sk = key_or_bytes

    @classmethod
    def generate(cls, key_length: int = 4096) -> "PrivateKey":
        return cls(rsa.generate_private_key(public_exponent=65537,
                                            key_size=key_length))

    @classmethod
    def generate_ec(cls) -> "PrivateKey":
        # GnuTLS SEC_PARAM_ULTRA ⇒ 521-bit curve (crypto.cpp:885-896)
        return cls(ec.generate_private_key(ec.SECP521R1()))

    def public_key(self) -> PublicKey:
        return PublicKey(self._sk.public_key())

    def get_public_key(self) -> PublicKey:
        return self.public_key()

    def sign(self, data: bytes) -> bytes:
        """SHA512 signature (crypto.cpp:307-321)."""
        data = bytes(data)
        if isinstance(self._sk, rsa.RSAPrivateKey):
            return self._sk.sign(data, padding.PKCS1v15(), hashes.SHA512())
        if isinstance(self._sk, ec.EllipticCurvePrivateKey):
            return self._sk.sign(data, ec.ECDSA(hashes.SHA512()))
        raise CryptoException("Can't sign data: unsupported key type")

    def decrypt(self, cipher: bytes) -> bytes:
        """Undo PublicKey.encrypt (crypto.cpp:323-356)."""
        if not isinstance(self._sk, rsa.RSAPrivateKey):
            raise CryptoException("Must be an RSA key")
        cipher = bytes(cipher)
        block = self._sk.key_size // 8
        if len(cipher) < block:
            raise DecryptError("Unexpected cipher length")
        try:
            head = self._sk.decrypt(cipher[:block], padding.PKCS1v15())
        except Exception as e:
            raise DecryptError("Can't decrypt data") from e
        if len(cipher) == block:
            return head
        return aes_decrypt(cipher[block:], head)

    def serialize(self, password: str = "") -> bytes:
        """PKCS#8 PEM, AES-256 password-encrypted when given
        (crypto.cpp:358-380)."""
        enc = (serialization.BestAvailableEncryption(password.encode())
               if password else serialization.NoEncryption())
        return self._sk.private_bytes(serialization.Encoding.PEM,
                                      serialization.PrivateFormat.PKCS8, enc)

    def __repr__(self):
        return f"PrivateKey({self.public_key().get_id()})"


# --------------------------------------------------------------- Certificate

_UID_OID = NameOID.USER_ID
_TEN_YEARS = datetime.timedelta(days=10 * 365)


def _der_cert_chunks(data: bytes):
    """Split concatenated DER certificates by reading ASN.1 TLV lengths."""
    i, n = 0, len(data)
    while i + 4 <= n and data[i] == 0x30:
        l0 = data[i + 1]
        if l0 < 0x80:
            end = i + 2 + l0
        else:
            nlen = l0 & 0x7F
            if nlen == 0 or i + 2 + nlen > n:
                break
            end = i + 2 + nlen + int.from_bytes(data[i + 2:i + 2 + nlen], "big")
        if end > n:
            break
        yield data[i:end]
        i = end


class Certificate:
    """x509 certificate + issuer chain (crypto.h:249-465).

    Packs/unpacks as concatenated DER, leaf first, like the reference's
    getPacked chain export."""

    __slots__ = ("_cert", "issuer", "revocation_lists")

    def __init__(self, cert_or_bytes, issuer: "Certificate | None" = None):
        self.issuer = issuer
        self.revocation_lists: list["RevocationList"] = []
        if isinstance(cert_or_bytes, (bytes, bytearray, memoryview)):
            raw = bytes(cert_or_bytes)
            certs = list(_der_cert_chunks(raw))
            if not certs:
                try:
                    certs = [c.public_bytes(serialization.Encoding.DER)
                             for c in x509.load_pem_x509_certificates(raw)]
                except Exception as e:
                    raise CryptoException("Can't load certificate") from e
            if not certs:
                raise CryptoException("Can't load certificate")
            self._cert = x509.load_der_x509_certificate(certs[0])
            if len(certs) > 1:
                self.issuer = Certificate(b"".join(certs[1:]))
        else:
            self._cert = cert_or_bytes

    # -- chain
    def chain(self):
        c: Optional[Certificate] = self
        while c is not None:
            yield c
            c = c.issuer

    def pack(self) -> bytes:
        return b"".join(c._cert.public_bytes(serialization.Encoding.DER)
                        for c in self.chain())

    def export_pem(self) -> bytes:
        return b"".join(c._cert.public_bytes(serialization.Encoding.PEM)
                        for c in self.chain())

    # -- accessors
    @property
    def x509(self) -> x509.Certificate:
        return self._cert

    def get_public_key(self) -> PublicKey:
        return PublicKey(self._cert.public_key())

    def get_id(self) -> InfoHash:
        return self.get_public_key().get_id()

    def get_long_id(self) -> PkId:
        return self.get_public_key().get_long_id()

    def _name_attr(self, name: x509.Name, oid) -> str:
        attrs = name.get_attributes_for_oid(oid)
        return attrs[0].value if attrs else ""

    def get_name(self) -> str:
        return self._name_attr(self._cert.subject, NameOID.COMMON_NAME)

    def get_uid(self) -> str:
        return self._name_attr(self._cert.subject, _UID_OID)

    def get_issuer_name(self) -> str:
        return self._name_attr(self._cert.issuer, NameOID.COMMON_NAME)

    def get_issuer_uid(self) -> str:
        return self._name_attr(self._cert.issuer, _UID_OID)

    def is_ca(self) -> bool:
        try:
            ext = self._cert.extensions.get_extension_for_oid(
                ExtensionOID.BASIC_CONSTRAINTS)
            return bool(ext.value.ca)
        except x509.ExtensionNotFound:
            return False

    def get_expiration(self) -> datetime.datetime:
        return self._cert.not_valid_after_utc

    # -- verification helpers
    def signed_by(self, issuer: "Certificate") -> bool:
        """Was this cert signed by `issuer`'s key?"""
        try:
            self._cert.verify_directly_issued_by(issuer._cert)
            return True
        except Exception:
            return False

    def __eq__(self, other):
        return (isinstance(other, Certificate)
                and self._cert == other._cert)

    def __hash__(self):
        return hash(self._cert)

    def __repr__(self):
        return f"Certificate({self.get_id()}, CN={self.get_name()!r})"

    # -- generation (Certificate::generate, crypto.cpp:925-995)
    @classmethod
    def generate(cls, key: PrivateKey, name: str = "dhtnode",
                 ca: "Identity | None" = None,
                 is_ca: bool = False) -> "Certificate":
        pk = key.public_key()
        pk_id = pk.get_id()
        subject = x509.Name([
            x509.NameAttribute(NameOID.COMMON_NAME, name),
            x509.NameAttribute(_UID_OID, str(pk_id)),
        ])
        now = datetime.datetime.now(datetime.timezone.utc)
        if ca is not None and ca.first is not None and ca.second is not None:
            if not ca.second.is_ca():
                raise CryptoException("Signing certificate must be CA")
            issuer_name = ca.second._cert.subject
            sign_key = ca.first._sk
            issuer_cert: Optional[Certificate] = ca.second
        else:
            issuer_name = subject
            sign_key = key._sk
            issuer_cert = None
        builder = (x509.CertificateBuilder()
                   .subject_name(subject)
                   .issuer_name(issuer_name)
                   .public_key(pk._pk)
                   .serial_number(secrets.randbits(63) | 1)
                   .not_valid_before(now)
                   .not_valid_after(now + _TEN_YEARS)
                   .add_extension(
                       x509.SubjectKeyIdentifier(bytes(pk_id)), critical=False)
                   .add_extension(
                       x509.BasicConstraints(ca=is_ca, path_length=None),
                       critical=True)
                   .add_extension(
                       x509.KeyUsage(
                           digital_signature=not is_ca,
                           content_commitment=False,
                           key_encipherment=False,
                           data_encipherment=not is_ca,
                           key_agreement=False,
                           key_cert_sign=is_ca,
                           crl_sign=is_ca,
                           encipher_only=False,
                           decipher_only=False),
                       critical=False))
        cert = builder.sign(sign_key, hashes.SHA512())
        return cls(cert, issuer=issuer_cert)


# ------------------------------------------------------------ RevocationList


class RevocationList:
    """x509 CRL wrapper (crypto.h:172-246, crypto.cpp:1005-1125)."""

    def __init__(self, data: Optional[bytes] = None):
        self._crl: Optional[x509.CertificateRevocationList] = None
        self._revoked: dict[int, datetime.datetime] = {}
        self._issuer: Optional[Certificate] = None
        if data is not None:
            self.unpack(bytes(data))

    def unpack(self, data: bytes) -> None:
        try:
            self._crl = x509.load_der_x509_crl(data)
        except Exception:
            try:
                self._crl = x509.load_pem_x509_crl(data)
            except Exception as e:
                raise CryptoException("Can't load CRL") from e
        self._revoked = {r.serial_number: r.revocation_date_utc
                         for r in self._crl}

    def pack(self) -> bytes:
        if self._crl is None:
            raise CryptoException("CRL not signed yet")
        return self._crl.public_bytes(serialization.Encoding.DER)

    def revoke(self, crt: Certificate,
               when: Optional[datetime.datetime] = None) -> None:
        when = when or datetime.datetime.now(datetime.timezone.utc)
        self._revoked[crt._cert.serial_number] = when

    def is_revoked(self, crt: Certificate) -> bool:
        return crt._cert.serial_number in self._revoked

    def sign(self, identity: "Identity",
             validity: datetime.timedelta = datetime.timedelta(days=7)):
        """Build + sign the CRL with the issuer identity
        (RevocationList::sign, crypto.cpp:1138-1170)."""
        key, cert = identity.first, identity.second
        now = datetime.datetime.now(datetime.timezone.utc)
        builder = (x509.CertificateRevocationListBuilder()
                   .issuer_name(cert._cert.subject)
                   .last_update(now)
                   .next_update(now + validity))
        for serial, when in self._revoked.items():
            builder = builder.add_revoked_certificate(
                x509.RevokedCertificateBuilder()
                .serial_number(serial)
                .revocation_date(when)
                .build())
        self._crl = builder.sign(key._sk, hashes.SHA512())
        self._issuer = cert

    def is_signed_by(self, issuer: Certificate) -> bool:
        if self._crl is None:
            return False
        try:
            return bool(self._crl.is_signature_valid(
                issuer._cert.public_key()))
        except Exception:
            return False

    def get_issuer_name(self) -> str:
        if self._crl is None:
            return ""
        attrs = self._crl.issuer.get_attributes_for_oid(NameOID.COMMON_NAME)
        return attrs[0].value if attrs else ""


# ------------------------------------------------------------------ Identity


class Identity:
    """(PrivateKey, Certificate) pair (crypto.h:62)."""

    __slots__ = ("first", "second")

    def __init__(self, key: Optional[PrivateKey] = None,
                 cert: Optional[Certificate] = None):
        self.first = key
        self.second = cert

    def __iter__(self):
        yield self.first
        yield self.second

    def __getitem__(self, i):
        return (self.first, self.second)[i]

    def __bool__(self):
        return self.first is not None and self.second is not None

    def __repr__(self):
        return f"Identity({self.second})" if self else "Identity(<empty>)"


def generate_identity(name: str = "dhtnode", ca: Optional[Identity] = None,
                      key_length: int = 4096,
                      is_ca: Optional[bool] = None) -> Identity:
    """generateIdentity (crypto.cpp:899-912): new RSA key + cert, CA-signed
    when a CA identity is given, else self-signed CA."""
    if is_ca is None:
        is_ca = not (ca and ca.first and ca.second)
    key = PrivateKey.generate(key_length)
    cert = Certificate.generate(key, name, ca, is_ca)
    return Identity(key, cert)


def generate_ec_identity(name: str = "dhtnode",
                         ca: Optional[Identity] = None,
                         is_ca: Optional[bool] = None) -> Identity:
    """generateEcIdentity (crypto.cpp:913-924). Note: EC identities can
    sign but not receive encrypted values (encrypt is RSA-only, as in the
    reference)."""
    if is_ca is None:
        is_ca = not (ca and ca.first and ca.second)
    key = PrivateKey.generate_ec()
    cert = Certificate.generate(key, name, ca, is_ca)
    return Identity(key, cert)


# ------------------------------------------------------------------ TrustList


class VerifyResult:
    __slots__ = ("valid", "reason")

    def __init__(self, valid: bool, reason: str = ""):
        self.valid = valid
        self.reason = reason

    def __bool__(self):
        return self.valid

    def __repr__(self):
        return f"VerifyResult({self.valid}, {self.reason!r})"


class TrustList:
    """Trusted-CA store with chain verification + CRLs (crypto.h:468-496)."""

    def __init__(self):
        self._roots: list[Certificate] = []
        self._crls: list[RevocationList] = []

    def add(self, crt: Certificate) -> None:
        for c in crt.chain():
            if c not in self._roots:
                self._roots.append(c)
        for crl in crt.revocation_lists:
            self.add_revocation_list(crl)

    def add_revocation_list(self, crl: RevocationList) -> None:
        self._crls.append(crl)

    def remove(self, crt: Certificate) -> None:
        self._roots = [c for c in self._roots if c != crt]

    def verify(self, crt: Certificate) -> VerifyResult:
        """Walk the presented chain; every link must verify, terminate at a
        trusted root, and no link may be revoked."""
        now = datetime.datetime.now(datetime.timezone.utc)
        chain = list(crt.chain())
        for c in chain:
            for crl in self._crls + c.revocation_lists:
                if crl.is_revoked(c):
                    return VerifyResult(False, "certificate revoked")
            na = c._cert.not_valid_after_utc
            if na < now:
                return VerifyResult(False, "certificate expired")
        # find link into the trust store
        for i, c in enumerate(chain):
            for root in self._roots:
                if c.signed_by(root):
                    for crl in self._crls:
                        if crl.is_revoked(c):
                            return VerifyResult(False, "certificate revoked")
                    # verify the presented chain below the trusted link
                    for j in range(i):
                        if not chain[j].signed_by(chain[j + 1]):
                            return VerifyResult(False, "broken chain")
                    return VerifyResult(True)
            if c in self._roots:
                for j in range(i):
                    if not chain[j].signed_by(chain[j + 1]):
                        return VerifyResult(False, "broken chain")
                return VerifyResult(True)
        return VerifyResult(False, "no trusted issuer")
