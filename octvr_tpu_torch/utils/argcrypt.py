"""Confidential child-process arguments (the OwlLive arg-encryption
role, apps/livestitching/encryptor.cpp:25-59).

The reference GUI encrypts the stitcher child's argument string with a
libsodium secretbox (random nonce + compiled-in key, base64 of
nonce||ciphertext) so stream keys / RTMP URLs never appear in `ps` or
process listings.  This is the same capability without the vendored
dependency or the baked-in secret:

* authenticated encryption from the stdlib only — HMAC-SHA256 in
  counter mode as the keystream, encrypt-then-MAC with an independent
  derived key and constant-time verification;
* the secret comes from the environment (``OCTVR_ARG_KEY``, hex),
  never from the source;
* the wire format is ``base64(nonce16 || ciphertext || tag16)`` and
  the plaintext is the argv joined with NUL (unambiguous for any
  argument content).

A supervisor spawns the stream child as
``python -m octvr_tpu_torch.cli.stream --args_enc <blob>``; the child
calls :func:`maybe_decrypt_argv` before parsing.

The port's copy of octvr_tpu/utils/argcrypt.py: the blob format is
shared, so a blob made by either package decrypts in the other.
"""

import base64
import hashlib
import hmac
import os
import secrets

NONCE_BYTES = 16
TAG_BYTES = 16
_BLOCK = hashlib.sha256().digest_size

ENV_KEY = "OCTVR_ARG_KEY"


class ArgCryptError(ValueError):
    pass


def load_key(env=None):
    """Key bytes from the OCTVR_ARG_KEY env var (hex, >= 16 bytes)."""
    raw = (env or os.environ).get(ENV_KEY)
    if not raw:
        raise ArgCryptError(
            f"{ENV_KEY} is not set (hex key, e.g. "
            f"`export {ENV_KEY}=$(python -c 'import secrets; "
            f"print(secrets.token_hex(32))')`)"
        )
    try:
        key = bytes.fromhex(raw.strip())
    except ValueError as e:
        raise ArgCryptError(f"{ENV_KEY} is not valid hex") from e
    if len(key) < 16:
        raise ArgCryptError(f"{ENV_KEY} must be at least 16 bytes")
    return key


def _derive(key, label):
    return hashlib.sha256(label + b"\x00" + key).digest()


def _keystream(enc_key, nonce, n):
    out = bytearray()
    counter = 0
    while len(out) < n:
        out += hmac.new(
            enc_key, nonce + counter.to_bytes(8, "big"), hashlib.sha256
        ).digest()
        counter += 1
    return bytes(out[:n])


def encrypt_args(argv, key):
    """argv (list of str) -> base64 blob (nonce || ct || tag)."""
    pt = "\x00".join(argv).encode("utf-8")
    enc_key = _derive(key, b"octvr-arg-enc")
    mac_key = _derive(key, b"octvr-arg-mac")
    nonce = secrets.token_bytes(NONCE_BYTES)
    ct = bytes(
        a ^ b for a, b in zip(pt, _keystream(enc_key, nonce, len(pt)))
    )
    tag = hmac.new(mac_key, nonce + ct, hashlib.sha256).digest()[:TAG_BYTES]
    return base64.b64encode(nonce + ct + tag).decode("ascii")


def decrypt_args(blob, key):
    """base64 blob -> argv list; raises ArgCryptError on tamper/garbage."""
    try:
        raw = base64.b64decode(blob.encode("ascii"), validate=True)
    except Exception as e:
        raise ArgCryptError("args_enc blob is not valid base64") from e
    if len(raw) < NONCE_BYTES + TAG_BYTES:
        raise ArgCryptError("args_enc blob too short")
    nonce = raw[:NONCE_BYTES]
    ct = raw[NONCE_BYTES:-TAG_BYTES]
    tag = raw[-TAG_BYTES:]
    mac_key = _derive(key, b"octvr-arg-mac")
    want = hmac.new(mac_key, nonce + ct, hashlib.sha256).digest()[:TAG_BYTES]
    if not hmac.compare_digest(tag, want):
        raise ArgCryptError("args_enc authentication failed (wrong key or "
                            "tampered blob)")
    enc_key = _derive(key, b"octvr-arg-enc")
    pt = bytes(
        a ^ b for a, b in zip(ct, _keystream(enc_key, nonce, len(ct)))
    )
    return pt.decode("utf-8").split("\x00") if pt else []


def maybe_decrypt_argv(argv):
    """CLI entry hook: ``["--args_enc", BLOB]`` -> the decrypted argv,
    anything else passes through unchanged."""
    if argv and len(argv) == 2 and argv[0] == "--args_enc":
        return decrypt_args(argv[1], load_key())
    return argv
