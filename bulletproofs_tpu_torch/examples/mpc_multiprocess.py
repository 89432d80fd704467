"""True multi-process MPC aggregation: each party runs in its OWN OS
process, and every protocol message crosses the process boundary as wire
bytes over a pipe (length-prefixed frames) -- the networked deployment the
reference's docs describe (reference docs/aggregation-api.md:8 "can be run
locally or across a network"; message structs at
src/range_proof/messages.rs:17-53 are serde wire types for exactly this).

Topology:

    dealer (this process)
      |  spawn m party processes; speak only wire bytes over stdin/stdout
      |-- round 1: hello{n,m,j,value} ->   <- BitCommitment bytes
      |-- round 2: BitChallenge bytes ->   <- PolyCommitment bytes
      |-- round 3: PolyChallenge bytes ->  <- ProofShare bytes
      '-- assemble + self-verify; on failure audit shares by index

Each party process runs this module's `party_main` (the module started
again with `--party`), derives its own generators and draws its own
blinding -- no secret state ever leaves the party except inside the
blinded share, exactly as in a real cross-host run.

Run: python -m bulletproofs_tpu_torch.examples.mpc_multiprocess [m]
         [--device cuda]

The protocol runs on the host, as in the JAX package; `--device` is
checked as every entry point of the port checks it.
"""

import argparse
import os
import secrets
import struct
import subprocess
import sys

PARTY_MODULE = "bulletproofs_tpu_torch.examples.mpc_multiprocess"
# the directory that holds the package, put on the parties' import path
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Rng:
    randbytes = staticmethod(secrets.token_bytes)


# -- frame codec: u32-LE length prefix ---------------------------------------

def send_frame(fh, payload: bytes):
    fh.write(struct.pack("<I", len(payload)) + payload)
    fh.flush()


def recv_frame(fh) -> bytes:
    hdr = fh.read(4)
    if len(hdr) != 4:
        raise EOFError("peer closed")
    (ln,) = struct.unpack("<I", hdr)
    data = fh.read(ln)
    if len(data) != ln:
        raise EOFError("short frame")
    return data


# -- party worker (runs in the child process) --------------------------------

def party_main():
    from bulletproofs_tpu_torch import BulletproofGens, PedersenGens, Scalar
    from bulletproofs_tpu_torch.proofs import messages as M
    from bulletproofs_tpu_torch.range_proof_mpc import Party

    rin = sys.stdin.buffer
    out = sys.stdout.buffer
    rng = Rng()

    n, m, j, value = struct.unpack("<IIIQ", recv_frame(rin))
    # the party derives generators itself (deterministic) and keeps its
    # blinding local -- the dealer never sees it
    pc_gens, bp_gens = PedersenGens(), BulletproofGens(n, m)
    blinding = Scalar.random(rng)

    party = Party.new(bp_gens, pc_gens, value, blinding, n)
    state, bitcom = party.assign_position(j, rng)
    send_frame(out, M.bit_commitment_to_bytes(bitcom))

    bit_challenge = M.bit_challenge_from_bytes(recv_frame(rin))
    state, polycom = state.apply_challenge(bit_challenge, rng)
    send_frame(out, M.poly_commitment_to_bytes(polycom))

    poly_challenge = M.poly_challenge_from_bytes(recv_frame(rin))
    share = state.apply_challenge(poly_challenge)
    send_frame(out, M.proof_share_to_bytes(share))


# -- dealer (parent process) -------------------------------------------------

def run_dealer(values, n=32, label=b"mpc multiprocess example",
               party_cmd=None):
    """Aggregate one proof of `values`, one party process each.
    `party_cmd` is the command that starts a party (by default this module
    with `--party` under the running interpreter)."""
    from bulletproofs_tpu_torch import BulletproofGens, PedersenGens, Transcript
    from bulletproofs_tpu_torch.proofs import messages as M
    from bulletproofs_tpu_torch.range_proof_mpc import Dealer

    rng = Rng()
    m = len(values)
    pc_gens, bp_gens = PedersenGens(), BulletproofGens(n, m)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    cmd = party_cmd or [sys.executable, "-m", PARTY_MODULE, "--party"]
    procs = [subprocess.Popen(cmd, stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE, env=env)
             for _ in range(m)]
    try:
        dealer = Dealer.new(bp_gens, pc_gens, Transcript(label), n, m)

        for j, (p, v) in enumerate(zip(procs, values)):
            send_frame(p.stdin, struct.pack("<IIIQ", n, m, j, v))
        bitcoms = [M.bit_commitment_from_bytes(recv_frame(p.stdout))
                   for p in procs]
        dealer, bit_challenge = dealer.receive_bit_commitments(bitcoms)

        wire = M.bit_challenge_to_bytes(bit_challenge)
        for p in procs:
            send_frame(p.stdin, wire)
        polycoms = [M.poly_commitment_from_bytes(recv_frame(p.stdout))
                    for p in procs]
        dealer, poly_challenge = dealer.receive_poly_commitments(polycoms)

        wire = M.poly_challenge_to_bytes(poly_challenge)
        for p in procs:
            send_frame(p.stdin, wire)
        shares = [M.proof_share_from_bytes(recv_frame(p.stdout))
                  for p in procs]

        # receive_shares self-verifies the assembled proof and audits the
        # individual shares on failure (MalformedProofShares{bad_shares})
        proof = dealer.receive_shares(shares, rng)
    finally:
        for p in procs:
            p.stdin.close()
            p.wait(timeout=60)
    failed = [j for j, p in enumerate(procs) if p.returncode]
    if failed:
        raise RuntimeError(f"party processes {failed} exited with "
                           f"{[procs[j].returncode for j in failed]}")

    vcs = [b.V_j for b in bitcoms]
    proof.verify_multiple(bp_gens, pc_gens, Transcript(label), vcs, n,
                          rng=rng)
    return proof


def main(m=4, device="cuda"):
    from bulletproofs_tpu_torch import MPCError
    from bulletproofs_tpu_torch.device import resolve_device
    resolve_device(device)
    values = [100 * (j + 1) + j for j in range(m)]
    proof = run_dealer(values)
    print(f"{m}-process aggregated proof: {len(proof.to_bytes())} bytes, "
          f"verified (every message crossed a process boundary as wire bytes)")

    # a dishonest party process: 64-bit value in a 32-bit proof; the dealer
    # audits the received shares and names the culprit index
    bad = list(values)
    bad[m // 2] = 1 << 40
    try:
        run_dealer(bad)
        raise SystemExit("dishonest party process was NOT detected")
    except MPCError as e:
        if e.kind != MPCError.MALFORMED_PROOF_SHARES \
                or e.bad_shares != [m // 2]:
            raise SystemExit(f"the wrong party process was blamed: {e}")
        print(f"dishonest party process detected: {e}")


if __name__ == "__main__":
    if "--party" in sys.argv:
        party_main()
    else:
        ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
        ap.add_argument("m", nargs="?", type=int, default=4)
        ap.add_argument("--device", default="cuda")
        args = ap.parse_args()
        main(args.m, args.device)
