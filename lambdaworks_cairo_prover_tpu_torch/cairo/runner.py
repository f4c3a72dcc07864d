"""Cairo program runner glue (reference src/cairo/runner/run.rs:242-263).

`generate_prover_args` runs a program on the built-in VM, builds public
inputs and the main trace.  Programs can come from compiled Cairo0 JSON
(`Program.from_json`) or from the hand-assembled generators in programs.py.
Raw VM output (binary `.trace`/`.memory` files produced by cairo-vm) can be
ingested with `generate_prover_args_from_trace_files`."""

from __future__ import annotations

import time
from enum import Enum

from ..prover.prove import proving_device
from .air import PublicInputs
from . import native as native_vm
from .cairo_mem import CairoMemory
from .execution_trace import build_main_trace
from .register_states import RegisterStates
from .vm import CairoVMError, Program, run_program


class CairoVersion(Enum):
    V0 = 0
    V1 = 1


class CairoLayout(Enum):
    """Cairo builtin layouts (reference src/cairo/cairo_layout.rs, with the
    builtin sets cairo-vm associates to each layout name).  A program's
    declared builtins must be a subset of the layout's, in layout order —
    the same validation cairo-vm performs when instantiating a runner."""

    Plain = "plain"
    Small = "small"
    Dex = "dex"
    Recursive = "recursive"
    Starknet = "starknet"
    StarknetWithKeccak = "starknet_with_keccak"
    RecursiveLargeOutput = "recursive_large_output"
    AllCairo = "all_cairo"
    AllSolidity = "all_solidity"
    Dynamic = "dynamic"

    @property
    def builtins(self) -> list[str]:
        return _LAYOUT_BUILTINS[self]


# cairo-lang's instance definitions (builtin order is part of the layout)
_LAYOUT_BUILTINS = {
    CairoLayout.Plain: [],
    CairoLayout.Small: ["output", "pedersen", "range_check", "ecdsa"],
    CairoLayout.Dex: ["output", "pedersen", "range_check", "ecdsa"],
    CairoLayout.Recursive: ["output", "pedersen", "range_check", "bitwise"],
    CairoLayout.Starknet: ["output", "pedersen", "range_check", "ecdsa",
                           "bitwise", "ec_op", "poseidon"],
    CairoLayout.StarknetWithKeccak: ["output", "pedersen", "range_check",
                                     "ecdsa", "bitwise", "ec_op", "keccak",
                                     "poseidon"],
    CairoLayout.RecursiveLargeOutput: ["output", "pedersen", "range_check",
                                       "bitwise"],
    CairoLayout.AllCairo: ["output", "pedersen", "range_check", "ecdsa",
                           "bitwise", "ec_op", "keccak", "poseidon",
                           "range_check96", "add_mod", "mul_mod"],
    CairoLayout.AllSolidity: ["output", "pedersen", "range_check", "ecdsa",
                              "bitwise", "ec_op"],
    CairoLayout.Dynamic: ["output", "pedersen", "range_check", "ecdsa",
                          "bitwise", "ec_op", "keccak", "poseidon"],
}


def validate_layout(program: Program, layout: CairoLayout) -> None:
    """Check the program's builtins against the layout (order + subset),
    as cairo-vm does when building a runner for that layout string."""
    allowed = layout.builtins
    try:
        positions = [allowed.index(b) for b in program.builtins]
    except ValueError:
        bad = [b for b in program.builtins if b not in allowed]
        raise CairoVMError(
            f"builtins {bad} not present in layout '{layout.value}'"
        )
    if positions != sorted(positions):
        raise CairoVMError(
            f"program builtins {program.builtins} out of layout order for "
            f"'{layout.value}' (expected order {allowed})"
        )


def run_vm(program: Program):
    """Run ``program`` on the native C++ VM where it can, else on the python
    VM.  Returns (vm name, register_states, memory, program_size,
    builtin_ranges).

    The C++ VM (bit-identical outputs) does the per-step interpretation far
    faster; it handles the output and range-check builtin segments.
    Programs with hints or deduction builtins (bitwise, pedersen, ec_op,
    keccak, poseidon, ecdsa) go to the python VM, which holds the hint
    processor and the deduction rules."""
    if (native_vm.available()
            and set(program.builtins) <= {"output", "range_check"}
            and not program.hints):
        return ("native",) + native_vm.run_program_native(program)
    return ("python",) + run_program(program)


def generate_prover_args(program: Program | bytes | str, output_range=None,
                         cairo_version: CairoVersion = CairoVersion.V0,
                         layout: CairoLayout | None = None, *,
                         device="cuda"):
    """Returns (main_trace: TraceTable, pub_inputs: PublicInputs); the trace
    tensor is made on ``device``, which should be the proving device.
    ``main_trace._timings`` holds the seconds of each stage ("vm",
    "trace_build", "ingest") and which VM ran ("vm_name").

    ``cairo_version=CairoVersion.V1`` treats `program` as a compiled CASM
    contract class and runs its first EXTERNAL entrypoint on the python VM
    (reference run.rs:242-263 with the V1 arm of run_program).

    ``layout`` defaults per version as the reference does (run.rs:247-250:
    V0 -> Small, V1 -> Plain).  For V0 it is validated against the
    program's declared builtins; the V1 entrypoint path ignores it —
    contract builtins come from the entrypoint record, not the layout,
    mirroring cairo-vm's run_from_entrypoint."""
    device = proving_device(device)
    t0 = time.perf_counter()
    if cairo_version is CairoVersion.V1:
        from .casm import CasmContractClass, run_casm_entrypoint

        casm = (program if isinstance(program, CasmContractClass)
                else CasmContractClass.from_json(program))
        vm_name = "python"
        register_states, memory, program_size, builtin_ranges = (
            run_casm_entrypoint(casm))
    else:
        if not isinstance(program, Program):
            program = Program.from_json(program)
        if layout is None:
            layout = CairoLayout.Small  # reference run.rs:247-250
        validate_layout(program, layout)
        vm_name, register_states, memory, program_size, builtin_ranges = (
            run_vm(program))
    vm_seconds = time.perf_counter() - t0

    memory_segments = {}
    if "range_check" in builtin_ranges:
        rng = builtin_ranges["range_check"]
        memory_segments["range_check"] = range(rng.start, rng.stop)
    if output_range is not None:
        memory_segments["output"] = output_range
    elif "output" in builtin_ranges:
        memory_segments["output"] = builtin_ranges["output"]

    pub_inputs = PublicInputs.from_regs_and_mem(
        register_states, memory, program_size, memory_segments
    )
    main_trace = build_main_trace(register_states, memory, pub_inputs,
                                  device=device)
    main_trace._timings.update(vm=vm_seconds, vm_name=vm_name)
    return main_trace, pub_inputs


def generate_prover_args_from_trace_files(
    trace_path: str, memory_path: str, program_size: int, memory_segments=None,
    *, device="cuda"
):
    """Ingest cairo-vm binary trace/memory files (register_states.rs:51-78,
    cairo_mem.rs:35-61 formats)."""
    device = proving_device(device)
    register_states = RegisterStates.from_file(trace_path)
    memory = CairoMemory.from_file(memory_path)
    pub_inputs = PublicInputs.from_regs_and_mem(
        register_states, memory, program_size, memory_segments or {}
    )
    main_trace = build_main_trace(register_states, memory, pub_inputs,
                                  device=device)
    return main_trace, pub_inputs
