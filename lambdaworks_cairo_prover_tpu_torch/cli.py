"""Command-line entry point (reference src/main.rs).

  python -m lambdaworks_cairo_prover_tpu_torch.cli prove <program.json> <out.proof>
  python -m lambdaworks_cairo_prover_tpu_torch.cli verify <proof_file>
  python -m lambdaworks_cairo_prover_tpu_torch.cli prove_and_verify <program.json>

``--device DEVICE`` (anywhere on the line) names the proving device:
``cuda`` by default, ``cuda:1``, or ``cpu``.  Proving on a CUDA device where
there is none fails with the prover's `ProvingError`; nothing moves to the
CPU by itself.  Verification runs on the host.

Proof files use the reference wire format: len(8B BE) ‖ proof ‖ pub_inputs.
"""

from __future__ import annotations

import sys
import time


def _prove(input_path: str, device: str):
    from .cairo.air import generate_cairo_proof
    from .cairo.runner import CairoVersion, generate_prover_args
    from .proof.options import ProofOptions

    with open(input_path, "rb") as f:
        content = f.read()
    # `.casm` files are Cairo1 contract classes (reference main.rs:16-18)
    version = CairoVersion.V1 if ".casm" in input_path else CairoVersion.V0
    if version is CairoVersion.V1:
        print("Running casm on CairoVM and generating trace ...")
    options = ProofOptions.default_test_options()
    t0 = time.perf_counter()
    main_trace, pub_inputs = generate_prover_args(content,
                                                  cairo_version=version,
                                                  device=device)
    proof = generate_cairo_proof(main_trace, pub_inputs, options,
                                 device=device)
    print(f"Time spent in proving: {time.perf_counter() - t0:.2f}s")
    return proof, pub_inputs, options


def _take_device(argv: list[str]) -> tuple[list[str], str]:
    """Split ``--device DEVICE`` off the argument list (default "cuda")."""
    argv = list(argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("--device needs a value (cuda, cuda:N or cpu)")
        device = argv[i + 1]
        del argv[i:i + 2]
    return argv, device


def main(argv=None):
    from .prover.prove import ProvingError

    argv, device = _take_device(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("Usage: cli <prove|verify|prove_and_verify> [arguments] "
              "[--device cuda|cuda:N|cpu]")
        return 1
    try:
        return _run(argv, device)
    except ProvingError as e:
        print(f"ProvingError: {e}", file=sys.stderr)
        return 2


def _run(argv: list[str], device: str) -> int:
    from .cairo.air import PublicInputs, verify_cairo_proof
    from .proof.options import ProofOptions
    from .proof.serde import read_proof_file, write_proof_file

    command = argv[0]
    if command == "prove":
        if len(argv) < 3:
            print("Usage: cli prove <input_path> <output_path>")
            return 1
        proof, pub_inputs, _ = _prove(argv[1], device)
        with open(argv[2], "wb") as f:
            f.write(write_proof_file(proof, pub_inputs.serialize()))
        print(f"Proof written to {argv[2]}")
        return 0

    if command == "verify":
        if len(argv) < 2:
            print("Usage: cli verify <input_path>")
            return 1
        with open(argv[1], "rb") as f:
            data = f.read()
        proof, rest = read_proof_file(data)
        pub_inputs = PublicInputs.deserialize(rest)
        options = ProofOptions.default_test_options()
        t0 = time.perf_counter()
        ok = verify_cairo_proof(proof, pub_inputs, options)
        print(f"Time spent in verifying: {time.perf_counter() - t0:.2f}s")
        print("Verification succeded" if ok else "Verification failed")
        return 0 if ok else 1

    if command == "prove_and_verify":
        if len(argv) < 2:
            print("Usage: cli prove_and_verify <input_path>")
            return 1
        proof, pub_inputs, options = _prove(argv[1], device)
        ok = verify_cairo_proof(proof, pub_inputs, options)
        print("Verification succeded" if ok else "Verification failed")
        return 0 if ok else 1

    print(f"Unknown command: {command}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
