"""Crypto: native cipher vs independent pure-Python spec implementation,
RFC test vectors, handshake/rekey semantics."""

import os
import struct

import pytest

from asciichat_tpu.net import crypto as C


def test_poly1305_rfc8439_vector():
    # RFC 8439 §2.5.2
    key = bytes.fromhex(
        "85d6be7857556d337f4452fe42d506a80103808afb0db2fd4abff6af4149f51b"
    )
    msg = b"Cryptographic Forum Research Group"
    want = bytes.fromhex("a8061dc1305136c6c22b8baf0c0127a9")
    assert C._py_poly1305(msg, key) == want
    # native agrees
    import ctypes

    tag = (ctypes.c_uint8 * 16)()
    C._lib().ac_poly1305(tag, msg, len(msg), key)
    assert bytes(tag) == want


def test_salsa20_core_shift_invariance():
    """Spec sanity: Salsa20 block output differs per counter and nonce."""
    key = bytes(range(32))
    n8 = bytes(8)
    b0 = C._py_salsa20_block(key, n8, 0)
    b1 = C._py_salsa20_block(key, n8, 1)
    assert len(b0) == 64 and b0 != b1


@pytest.mark.parametrize("size", [0, 1, 31, 32, 33, 63, 64, 65, 1000, 5000])
def test_native_secretbox_matches_python(size):
    key = os.urandom(32)
    nonce = os.urandom(24)
    msg = os.urandom(size)
    assert C.secretbox(msg, nonce, key) == C._py_secretbox(msg, nonce, key)


def test_secretbox_roundtrip_and_tamper():
    key = os.urandom(32)
    nonce = os.urandom(24)
    msg = b"attack at dawn" * 100
    boxed = C.secretbox(msg, nonce, key)
    assert C.secretbox_open(boxed, nonce, key) == msg
    bad = bytearray(boxed)
    bad[20] ^= 1
    with pytest.raises(ValueError):
        C.secretbox_open(bytes(bad), nonce, key)
    with pytest.raises(ValueError):
        C.secretbox_open(boxed, os.urandom(24), key)


def test_hsalsa20_native_matches_python():
    import ctypes

    key = os.urandom(32)
    n16 = os.urandom(16)
    out = (ctypes.c_uint8 * 32)()
    C._lib().ac_hsalsa20(out, key, n16)
    assert bytes(out) == C._py_hsalsa20(key, n16)


def test_x25519_rfc7748_vector():
    from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey

    # RFC 7748 §6.1 Diffie-Hellman test vector
    alice_priv = bytes.fromhex(
        "77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a"
    )
    bob_pub = bytes.fromhex(
        "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f"
    )
    _priv_cls, pub_cls = C._x25519()  # the classes CryptoContext uses
    shared = X25519PrivateKey.from_private_bytes(alice_priv).exchange(
        pub_cls.from_public_bytes(bob_pub)
    )
    assert shared == bytes.fromhex(
        "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"
    )


def test_context_exchange_and_encrypt():
    a, b = C.CryptoContext(), C.CryptoContext()
    a.compute_shared(b.public_key)
    b.compute_shared(a.public_key)
    assert a.shared_key == b.shared_key
    ct = a.encrypt(b"hello")
    assert b.decrypt(ct) == b"hello"
    # nonce layout: session_id(16) + BE counter starting at 1 (crypto.c:54-73)
    assert ct[:16] == a.session_id
    assert struct.unpack(">Q", ct[16:24])[0] == 1
    ct2 = a.encrypt(b"world")
    assert struct.unpack(">Q", ct2[16:24])[0] == 2


def test_challenge_response():
    a, b = C.CryptoContext(), C.CryptoContext()
    a.compute_shared(b.public_key)
    b.compute_shared(a.public_key)
    chal = a.make_challenge()
    assert a.verify_challenge_answer(b.answer_challenge(chal))
    a2 = C.CryptoContext()
    a2.compute_shared(b.public_key)
    a2.auth_nonce = chal
    assert not a.verify_challenge_answer(b"x" * 32)


def test_rekey_thresholds_and_flow():
    a = C.CryptoContext(packet_threshold=3)
    b = C.CryptoContext(packet_threshold=3)
    a.compute_shared(b.public_key)
    b.compute_shared(a.public_key)
    old_key = a.shared_key
    for _ in range(3):
        b.decrypt(a.encrypt(b"x"))
    assert a.needs_rekey()
    pub_a = a.start_rekey()
    pub_b = b.start_rekey()
    a.finish_rekey(pub_b)
    b.finish_rekey(pub_a)
    assert a.shared_key == b.shared_key != old_key
    assert not a.needs_rekey() and a.nonce_counter == 1
    assert b.decrypt(a.encrypt(b"after rekey")) == b"after rekey"


def test_password_mode():
    a, b = C.CryptoContext(), C.CryptoContext()
    a.set_password("hunter2")
    b.set_password("hunter2")
    assert b.decrypt(a.encrypt(b"pw mode")) == b"pw mode"
    c = C.CryptoContext()
    c.set_password("wrong")
    with pytest.raises(ValueError):
        c.decrypt(a.encrypt(b"pw mode"))


def test_secure_channel_with_rekey_over_tcp():
    """Full SecureChannel flow over a real localhost socket, with a rekey
    triggered mid-stream (packet_threshold=5)."""
    import asyncio

    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.net.handshake import SecureChannel, client_handshake, server_handshake
    from asciichat_tpu.net.transport import Transport, connect_tcp

    async def run():
        results = {}

        async def on_server(t: Transport):
            ctx = C.CryptoContext(packet_threshold=5)
            first = await t.recv()
            assert await server_handshake(t, ctx, first)
            chan = SecureChannel(t, ctx, initiator=False)
            got = []
            for _ in range(20):
                ptype, payload = await chan.recv()
                got.append(payload)
                await chan.send(pkt.PacketType.PONG, payload)
            results["server_rekeys"] = ctx.rekey.count
            results["got"] = got
            done.set()

        done = asyncio.Event()
        server = await asyncio.start_server(
            lambda r, w: on_server(Transport(r, w)), "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]

        t = await connect_tcp("127.0.0.1", port)
        ctx = C.CryptoContext(packet_threshold=5)
        assert await client_handshake(t, ctx)
        chan = SecureChannel(t, ctx, initiator=True)
        echoed = []
        for i in range(20):
            msg = f"message {i}".encode()
            await chan.send(pkt.PacketType.PING, msg)
            ptype, payload = await chan.recv()
            assert ptype == pkt.PacketType.PONG
            echoed.append(payload)
        await asyncio.wait_for(done.wait(), 10)
        await chan.close()
        server.close()
        results["client_rekeys"] = ctx.rekey.count
        results["echoed"] = echoed
        return results

    r = asyncio.run(asyncio.wait_for(run(), 60))
    assert r["echoed"] == [f"message {i}".encode() for i in range(20)]
    assert r["got"] == r["echoed"]
    # at least one rekey fired on both sides past the 5-packet threshold
    assert r["client_rekeys"] >= 1 and r["server_rekeys"] >= 1


def test_previous_key_expires_after_grace():
    import time as time_mod

    a = C.CryptoContext()
    b = C.CryptoContext()
    a.compute_shared(b.public_key)
    b.compute_shared(a.public_key)
    ct_old = a.encrypt(b"from the old key")
    pub_a, pub_b = a.start_rekey(), b.start_rekey()
    a.finish_rekey(pub_b)
    b.finish_rekey(pub_a)
    # within grace: old-key packet still decrypts
    assert b.decrypt(ct_old) == b"from the old key"
    # after grace: old key is retired
    b._previous_key_expiry = time_mod.monotonic() - 1
    ct_old2 = bytearray(ct_old)
    with pytest.raises(ValueError):
        b.decrypt(bytes(ct_old2))
    assert b.previous_key is None  # zeroized


def test_unsolicited_rekey_response_rejected():
    a = C.CryptoContext()
    b = C.CryptoContext()
    a.compute_shared(b.public_key)
    with pytest.raises(ValueError):
        a.finish_rekey(b.public_key)  # no rekey in progress


def test_challenge_requires_key_exchange():
    a = C.CryptoContext()
    a.set_password("pw")
    with pytest.raises(ValueError):
        a.answer_challenge(b"x" * 32)  # DH binding is mandatory


def test_injected_rekey_request_cannot_hijack_session():
    """An attacker who injects a plaintext CRYPTO_REKEY_REQUEST must not be
    able to replace the session key: the responder holds the new key PENDING
    and only commits once a packet decrypts under it (proof-of-possession,
    handshake/common.c:586+, crypto.c:1225)."""
    a = C.CryptoContext()
    b = C.CryptoContext()
    a.compute_shared(b.public_key)
    b.compute_shared(a.public_key)
    old_key = b.shared_key

    attacker = C.CryptoContext()
    b.respond_rekey(attacker.public_key)  # forged request handled
    # current key untouched: legitimate traffic still flows
    assert b.shared_key == old_key
    assert b.decrypt(a.encrypt(b"still the old key")) == b"still the old key"
    assert b.rekey.count == 0  # never committed
    # the attacker (who does not know b's temp pubkey response... even with
    # it, cannot craft a proof without the DH secret) -> garbage proof fails
    with pytest.raises(ValueError):
        b.decrypt(os.urandom(60))
    assert b.shared_key == old_key


def test_pending_rekey_commits_on_proof():
    """Responder commits the pending key exactly when a packet decrypts
    under it (the REKEY_COMPLETE proof or an overtaking data packet)."""
    a = C.CryptoContext()
    b = C.CryptoContext()
    a.compute_shared(b.public_key)
    b.compute_shared(a.public_key)
    pub_a = a.start_rekey()
    pub_b = b.respond_rekey(pub_a)
    a.finish_rekey(pub_b)  # initiator commits on response
    assert b.rekey.count == 0
    proof = a.encrypt(b"REKEY-OK")
    assert b.decrypt(proof) == b"REKEY-OK"
    assert b.rekey.count == 1  # committed on proof
    assert b.shared_key == a.shared_key
    assert b.decrypt(a.encrypt(b"new key traffic")) == b"new key traffic"


def test_incoming_rekey_rate_limited():
    b = C.CryptoContext()
    assert b.allow_incoming_rekey()
    assert not b.allow_incoming_rekey()  # within MIN_INCOMING_REKEY_INTERVAL_S
    b._last_incoming_rekey = 0.0
    assert b.allow_incoming_rekey()


def test_no_encryption_downgrade_rejected_when_auth_required():
    """CRYPTO_NO_ENCRYPTION (1109) is inside the handshake packet range but
    must NOT bypass a password requirement (server.c:177-189)."""
    import asyncio

    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.net.handshake import HandshakeError, server_handshake

    class NullTransport:
        async def send(self, *a, **k):
            pass

        async def recv(self):
            raise AssertionError("should not read past the downgrade attempt")

    ctx = C.CryptoContext()
    ctx.set_password("pw")
    first = (pkt.PacketType.CRYPTO_NO_ENCRYPTION, b"")
    with pytest.raises(HandshakeError):
        asyncio.run(server_handshake(NullTransport(), ctx, first, require_auth=True))
    # without auth it remains a valid plaintext opt-out
    ok = asyncio.run(server_handshake(NullTransport(), C.CryptoContext(), first,
                                      require_auth=False))
    assert ok is False


def test_argon2id_rfc9106_vector():
    """RFC 9106 §5.3 Argon2id known-answer test (t=3, m=32 KiB, p=4, with
    secret + associated data) against native/argon2.cpp."""
    got = C.argon2id(b"\x01" * 32, b"\x02" * 16, t=3, m_kib=32, parallelism=4,
                     outlen=32, secret=b"\x03" * 8, ad=b"\x04" * 12)
    assert got.hex() == (
        "0d640df58d78766c08c037a34a8b53c9d01ef0452d75b65eb52520e96b01e659"
    )


def test_argon2id_cross_validation():
    """Cross-validate against TWO independent implementations (argon2-cffi
    and cryptography's Argon2id) over varied parameters."""
    from argon2.low_level import Type, hash_secret_raw

    for t, m, p in [(1, 8, 1), (2, 64, 2), (3, 128, 4)]:
        pw, salt = os.urandom(10), os.urandom(16)
        ref = hash_secret_raw(pw, salt, time_cost=t, memory_cost=m,
                              parallelism=p, hash_len=32, type=Type.ID)
        assert C.argon2id(pw, salt, t=t, m_kib=m, parallelism=p) == ref

    from cryptography.hazmat.primitives.kdf.argon2 import Argon2id

    pw, salt = b"correct horse", os.urandom(16)
    ref2 = Argon2id(salt=salt, length=32, iterations=2, lanes=1,
                    memory_cost=64).derive(pw)
    assert C.argon2id(pw, salt, t=2, m_kib=64, parallelism=1) == ref2


def test_password_kdf_is_argon2id_with_reference_params():
    """set_password derives via Argon2id with the reference's effective
    libsodium-INTERACTIVE parameters and deterministic salt
    (crypto.c:336-352): same password -> same key on both sides."""
    a, b = C.CryptoContext(), C.CryptoContext()
    a.set_password("hunter2")
    b.set_password("hunter2")
    assert a.password_key == b.password_key
    want = C.argon2id(b"hunter2", b"ascii-chat-password-salt-v1"[:16],
                      t=2, m_kib=65536, parallelism=1)
    assert a.password_key == want


def test_plaintext_rekey_injection_ignored_by_channel():
    """Review finding (r2): rekey messages must travel INSIDE the encrypted
    channel. A plaintext CRYPTO_REKEY_REQUEST injected by an on-path
    attacker is dropped — no REKEY_RESPONSE leaks the ephemeral key and the
    session key is untouched — while legitimate in-channel rekeys work."""
    import asyncio

    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.net.handshake import SecureChannel, client_handshake, server_handshake
    from asciichat_tpu.net.transport import Transport, connect_tcp

    async def run():
        results = {}

        async def on_server(t: Transport):
            ctx = C.CryptoContext(packet_threshold=4)
            first = await t.recv()
            assert await server_handshake(t, ctx, first)
            chan = SecureChannel(t, ctx, initiator=False)
            for _ in range(12):
                ptype, payload = await chan.recv()
                await chan.send(pkt.PacketType.PONG, payload)
            results["server_key"] = ctx.shared_key
            results["server_rekeys"] = ctx.rekey.count

        server = await asyncio.start_server(
            lambda r, w: on_server(Transport(r, w)), "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        t = await connect_tcp("127.0.0.1", port)
        ctx = C.CryptoContext(packet_threshold=4)
        assert await client_handshake(t, ctx)
        chan = SecureChannel(t, ctx, initiator=True)

        # attacker injects a PLAINTEXT rekey request with a key it knows
        attacker = C.CryptoContext()
        await t.send(pkt.PacketType.CRYPTO_REKEY_REQUEST, attacker.public_key)

        for i in range(12):
            await chan.send(pkt.PacketType.PING, b"x%d" % i)
            ptype, payload = await chan.recv()
            assert ptype == pkt.PacketType.PONG
        await asyncio.sleep(0.1)
        await chan.close()
        server.close()
        # the legitimate in-channel rekey still fired past the threshold...
        assert results["server_rekeys"] >= 1
        # ...and the attacker cannot know the session key: it differs from
        # any DH the attacker could compute from on-wire plaintext (the
        # responder never answered the plaintext request)
        assert results["server_key"] == ctx.shared_key
        return results

    asyncio.run(asyncio.wait_for(run(), 30))


def test_mutual_auth_detects_fake_server():
    """Mutual authentication (CRYPTO_SERVER_AUTH_RESP,
    handshake/{client.c:840,server.c:613}): a fake server that does not know
    the password cannot silently accept a password client — the client
    requires the server's HMAC over ITS challenge and aborts otherwise."""
    import asyncio

    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.net.handshake import (
        HandshakeError, client_handshake, server_handshake,
    )
    from asciichat_tpu.net.transport import Transport, connect_tcp

    async def run():
        # 1) legit password server: mutual auth succeeds
        async def legit(t: Transport):
            ctx = C.CryptoContext()
            ctx.set_password("s3cret")
            first = await t.recv()
            await server_handshake(t, ctx, first, require_auth=True)

        server = await asyncio.start_server(
            lambda r, w: legit(Transport(r, w)), "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        t = await connect_tcp("127.0.0.1", port)
        assert await client_handshake(t, C.CryptoContext(), password="s3cret")
        await t.close()
        server.close()

        # 2) FAKE server: accepts anything without proving the password
        async def fake(t: Transport):
            P = pkt.PacketType
            await t.recv()  # capabilities
            ctx = C.CryptoContext()
            from asciichat_tpu.net.handshake import pack_parameters

            await t.send(P.CRYPTO_PARAMETERS, pack_parameters(True))
            await t.send(P.CRYPTO_KEY_EXCHANGE_INIT, ctx.public_key)
            await t.recv()  # client pubkey
            await t.send(P.CRYPTO_AUTH_CHALLENGE, b"\x00" * 32)
            await t.recv()  # client's HMAC (fake server can't verify it)
            await t.send(P.CRYPTO_HANDSHAKE_COMPLETE)  # silent accept

        server = await asyncio.start_server(
            lambda r, w: fake(Transport(r, w)), "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        t = await connect_tcp("127.0.0.1", port)
        with pytest.raises(HandshakeError, match="MITM|mutual"):
            await client_handshake(t, C.CryptoContext(), password="s3cret")
        await t.close()
        server.close()

    asyncio.run(asyncio.wait_for(run(), 30))


def test_secure_channel_rejects_replay_reflection_and_plaintext_injection():
    """Three on-path attacks against the encrypted channel must all surface
    as the bad-data ValueError (caller disconnects):
    - REPLAY: a recorded ENCRYPTED packet re-presented later (nonce counter
      not strictly increasing per sender prefix);
    - REFLECTION: a peer's own ciphertext bounced back (both directions use
      one symmetric key; only the nonce prefix distinguishes them);
    - PLAINTEXT INJECTION: a non-crypto packet framed in plaintext after
      encryption was established."""
    import asyncio

    import pytest as _pytest

    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.net.handshake import SecureChannel

    class Pipe:
        """In-memory bidirectional transport pair with injectable frames."""

        def __init__(self):
            self.q = asyncio.Queue()

        async def send(self, ptype, payload=b""):
            await self.peer.q.put((ptype, payload))

        def send_nowait(self, ptype, payload=b"", **kw):
            self.peer.q.put_nowait((ptype, payload))
            return True

        async def recv(self):
            return await self.q.get()

        async def close(self):
            pass

        peername = ("pipe", 0)

    async def run():
        a_t, b_t = Pipe(), Pipe()
        a_t.peer, b_t.peer = b_t, a_t
        actx, bctx = C.CryptoContext(), C.CryptoContext()
        actx.compute_shared(bctx.public_key)
        bctx.compute_shared(actx.public_key)
        actx.handshake_complete = bctx.handshake_complete = True
        a = SecureChannel(a_t, actx, initiator=True)
        b = SecureChannel(b_t, bctx, initiator=False)

        # baseline: traffic flows
        await a.send(pkt.PacketType.PING, b"one")
        recorded = await b_t.q.get()  # capture the wire frame
        b_t.q.put_nowait(recorded)
        assert (await b.recv())[1] == b"one"

        # REPLAY: same ciphertext again
        b_t.q.put_nowait(recorded)
        with _pytest.raises(ValueError, match="replayed"):
            await b.recv()

        # REFLECTION: b's own output bounced back to b
        await b.send(pkt.PacketType.PONG, b"mine")
        bounced = await a_t.q.get()
        b_t.q.put_nowait(bounced)
        with _pytest.raises(ValueError, match="reflected"):
            await b.recv()

        # PLAINTEXT INJECTION: attacker frames an unencrypted packet
        b_t.q.put_nowait((pkt.PacketType.SIZE_MESSAGE, b"\x00\x10\x00\x10"))
        with _pytest.raises(ValueError, match="plaintext"):
            await b.recv()

        # the channel still works for legit traffic after rejecting attacks
        await a.send(pkt.PacketType.PING, b"two")
        assert (await b.recv())[1] == b"two"

    asyncio.run(asyncio.wait_for(run(), 30))


def test_key_mode_requires_server_host_proof(tmp_path):
    """SSH-identity mode: a fake server that accepts the client's signature
    WITHOUT proving a host identity must be rejected (the MITM that key mode
    previously allowed), and a host-key CHANGE must be rejected by the
    known_hosts pin."""
    import asyncio

    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey
    from cryptography.hazmat.primitives.serialization import (
        Encoding, NoEncryption, PrivateFormat,
    )

    from asciichat_tpu.net import identity as ident
    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.net import sshauth
    from asciichat_tpu.net.handshake import (
        HandshakeError, client_handshake, server_handshake,
    )
    from asciichat_tpu.net.knownhosts import KnownHosts
    from asciichat_tpu.net.transport import Transport, connect_tcp

    key = Ed25519PrivateKey.generate()
    keyfile = tmp_path / "id"
    keyfile.write_bytes(key.private_bytes(
        Encoding.PEM, PrivateFormat.OpenSSH, NoEncryption()))
    ssh_id = sshauth.SshIdentity.from_private_key_file(str(keyfile))
    allowed = sshauth.AuthorizedKeys([ssh_id.key_blob])
    kh_file = str(tmp_path / "known_hosts")

    async def fake_server_no_proof(t: Transport):
        """Impostor: runs the handshake but never sends SERVER_AUTH_RESP."""
        P = pkt.PacketType
        first = await t.recv()  # CRYPTO_CAPABILITIES
        from asciichat_tpu.net.handshake import pack_parameters

        ctx = C.CryptoContext()
        await t.send(P.CRYPTO_PARAMETERS, pack_parameters(True))
        await t.send(P.CRYPTO_KEY_EXCHANGE_INIT, ctx.public_key)
        ptype, payload = await t.recv()
        ctx.compute_shared(payload[:32])
        await t.send(P.CRYPTO_AUTH_CHALLENGE, b"\x01" * 32)
        await t.recv()  # discard the signature
        await t.send(P.CRYPTO_HANDSHAKE_COMPLETE)

    async def real_server(t: Transport, host_identity):
        ctx = C.CryptoContext()
        first = await t.recv()
        await server_handshake(t, ctx, first, require_auth=True,
                               allowed_keys=allowed,
                               host_identity=host_identity)

    async def run():
        # (1) impostor without a host proof -> HandshakeError
        srv = await asyncio.start_server(
            lambda r, w: fake_server_no_proof(Transport(r, w)),
            "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        t = await connect_tcp("127.0.0.1", port)
        with pytest.raises(HandshakeError, match="host identity"):
            await client_handshake(t, C.CryptoContext(), ssh_identity=ssh_id,
                                   known_hosts=KnownHosts(kh_file),
                                   server_id="127.0.0.1:x")
        await t.close()
        srv.close()

        # (2) legit server pins on first use...
        hid1 = ident.Identity()
        srv = await asyncio.start_server(
            lambda r, w: real_server(Transport(r, w), hid1), "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        t = await connect_tcp("127.0.0.1", port)
        assert await client_handshake(t, C.CryptoContext(), ssh_identity=ssh_id,
                                      known_hosts=KnownHosts(kh_file),
                                      server_id="srv:1")
        await t.close()
        srv.close()

        # (3) ...and a DIFFERENT host key for the same server_id is rejected
        hid2 = ident.Identity()
        srv = await asyncio.start_server(
            lambda r, w: real_server(Transport(r, w), hid2), "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        t = await connect_tcp("127.0.0.1", port)
        with pytest.raises(HandshakeError, match="MISMATCH"):
            await client_handshake(t, C.CryptoContext(), ssh_identity=ssh_id,
                                   known_hosts=KnownHosts(kh_file),
                                   server_id="srv:1")
        await t.close()
        srv.close()

    asyncio.run(asyncio.wait_for(run(), 60))


def test_stale_envelope_rejected():
    """Signed ACDS envelopes carry a signed timestamp: one outside the
    freshness window is rejected (bounded same-type replay)."""
    import struct as _struct
    import time as _time

    from asciichat_tpu.net import identity as ident

    me = ident.Identity()
    env = me.sign(6000, b'{"x":1}')
    pub, body = ident.open_envelope(6000, env)  # fresh: verifies
    assert body == b'{"x":1}'
    # forge staleness by re-signing with an old timestamp
    old_ts = _struct.pack(">Q", int((_time.time() - 3600) * 1000))
    sig = me._private.sign(_struct.pack(">H", 6000) + old_ts + b'{"x":1}')
    stale = me.public_bytes + sig + old_ts + b'{"x":1}'
    with pytest.raises(ident.SignatureError, match="stale"):
        ident.open_envelope(6000, stale)


def test_secure_channel_tolerates_bounded_reordering_and_rekeys_on_nowait():
    """Review fixes: (a) the anti-replay check is a sliding WINDOW — two
    legitimate packets whose counters swapped on the wire (executor-thread
    send_nowait marshalled after a loop-thread send) must BOTH decrypt;
    duplicates and >64-counter-old packets still die. (b) the forward-
    security rekey thresholds gate send_nowait too — all steady-state
    traffic flows through it, so send()-only checking made the 1M-packet/
    1-hour rekey unreachable."""
    import asyncio

    import pytest as _pytest

    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.net.handshake import SecureChannel

    class Pipe:
        def __init__(self):
            self.q = asyncio.Queue()

        async def send(self, ptype, payload=b""):
            await self.peer.q.put((ptype, payload))

        def send_nowait(self, ptype, payload=b"", **kw):
            self.peer.q.put_nowait((ptype, payload))
            return True

        async def recv(self):
            return await self.q.get()

        async def close(self):
            pass

        peername = ("pipe", 0)

    async def run():
        a_t, b_t = Pipe(), Pipe()
        a_t.peer, b_t.peer = b_t, a_t
        actx, bctx = C.CryptoContext(), C.CryptoContext()
        actx.compute_shared(bctx.public_key)
        bctx.compute_shared(actx.public_key)
        actx.handshake_complete = bctx.handshake_complete = True
        a = SecureChannel(a_t, actx, initiator=True)
        b = SecureChannel(b_t, bctx, initiator=False)

        # (a) swap two packets on the wire
        await a.send(pkt.PacketType.PING, b"first")
        await a.send(pkt.PacketType.PING, b"second")
        f1 = b_t.q.get_nowait()
        f2 = b_t.q.get_nowait()
        b_t.q.put_nowait(f2)  # arrives out of counter order
        b_t.q.put_nowait(f1)
        assert (await b.recv())[1] == b"second"
        assert (await b.recv())[1] == b"first"
        # duplicate of the reordered packet still dies
        b_t.q.put_nowait(f1)
        with _pytest.raises(ValueError, match="replayed"):
            await b.recv()
        # far-too-old counters die even if never seen: send 70 more, then
        # replay an early frame from beyond the 64-wide window
        early = f2
        for i in range(70):
            await a.send(pkt.PacketType.PING, b"x%d" % i)
        for _ in range(70):
            await b.recv()
        b_t.q.put_nowait(early)
        with _pytest.raises(ValueError, match="replayed"):
            await b.recv()

        # (b) crossing the packet threshold via send_nowait triggers rekey
        actx.rekey.packet_count = actx.packet_threshold + 1  # crypto.c:143
        assert a.send_nowait(pkt.PacketType.PING, b"tick")
        types = []
        while not b_t.q.empty():
            inner_type, payload = await b.recv()
            types.append(inner_type)
        assert pkt.PacketType.CRYPTO_REKEY_REQUEST in types or \
            actx.rekey.in_progress, "send_nowait never initiated the rekey"

    asyncio.run(asyncio.wait_for(run(), 30))


def test_secretbox_length_guards_are_raises():
    """FFI-boundary length checks must be real ValueErrors, not asserts —
    asserts vanish under `python -O` and a short nonce/key would become an
    out-of-bounds native read in sodium.cpp."""
    import pytest

    from asciichat_tpu.net import crypto

    with pytest.raises(ValueError):
        crypto.secretbox(b"m", b"\x00" * 16, b"\x00" * 32)
    with pytest.raises(ValueError):
        crypto.secretbox(b"m", b"\x00" * 24, b"\x00" * 16)
    with pytest.raises(ValueError):
        crypto.secretbox_open(b"\x00" * 32, b"\x00" * 16, b"\x00" * 32)


def test_argon2id_rejects_rfc_invalid_params():
    """RFC 9106 §3.1: tagLen >= 4 and saltLen >= 8. Accepting less would
    return a degenerate tag with rc=0 (the exported ac_blake2b already
    guards its own outlen for the same reason)."""
    import pytest

    from asciichat_tpu.net import crypto

    with pytest.raises(ValueError):
        crypto.argon2id(b"pw", b"\x00" * 16, t=1, m_kib=8, outlen=0)
    with pytest.raises(ValueError):
        crypto.argon2id(b"pw", b"\x00" * 16, t=1, m_kib=8, outlen=3)
    with pytest.raises(ValueError):
        crypto.argon2id(b"pw", b"\x00" * 7, t=1, m_kib=8, outlen=32)
    # smallest valid combination still works
    assert len(crypto.argon2id(b"pw", b"\x00" * 8, t=1, m_kib=8, outlen=4)) == 4


def test_answer_without_challenge_is_auth_failure():
    """verify_challenge_answer before make_challenge must fail auth cleanly,
    not crash with AttributeError (auth_nonce was never initialized)."""
    from asciichat_tpu.net import crypto

    a = crypto.CryptoContext()
    b = crypto.CryptoContext()
    a.compute_shared(b.public_key)
    b.compute_shared(a.public_key)
    assert a.verify_challenge_answer(b"\x00" * 32) is False


def test_encrypt_is_atomic_across_rekey_commit():
    """encrypt() must take its (session_id, counter, key) snapshot under the
    same lock _commit_pending swaps them under: an interleaving used to
    re-issue old_session||1 (already consumed), which the peer's replay
    window rejects — tearing down a healthy session at rekey time."""
    import threading

    from asciichat_tpu.net import crypto

    a = crypto.CryptoContext()
    b = crypto.CryptoContext()
    a.compute_shared(b.public_key)
    b.compute_shared(a.public_key)

    seen: list[bytes] = []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            seen.append(a.encrypt(b"x"))

    th = threading.Thread(target=hammer)
    th.start()
    try:
        for _ in range(50):
            pub = a.start_rekey()
            # drive the real responder path so keys stay in sync
            resp_pub = b.respond_rekey(pub)
            a.finish_rekey(resp_pub)
            # proof-of-possession packet commits b's pending key
            b.decrypt(a.encrypt(b"proof"))
    finally:
        stop.set()
        th.join()

    # invariant: per nonce prefix, (counter unique) and (exactly one key
    # was used) — a torn snapshot shows up as a duplicate (prefix, counter)
    per_prefix: dict[bytes, set[int]] = {}
    for ct in seen:
        sid, ctr = ct[:16], int.from_bytes(ct[16:24], "big")
        assert ctr not in per_prefix.setdefault(sid, set()), \
            "duplicate (session_id, counter) — nonce reuse across rekey"
        per_prefix[sid].add(ctr)
