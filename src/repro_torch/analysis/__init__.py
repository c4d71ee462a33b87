"""Contract checking for the port's serving programs.

Port of ``repro/analysis``.  The serving stack rests on invariants that a
later change can break silently: one slot (one capture of CUDA graphs) per
cap bucket, no host sync inside a captured program, no traffic between the
shards of a mesh, counter-based bootstrap randomness (a request's draws
follow it into any lane), slot tensors written in place (the graphs read
fixed addresses).  ``contracts`` declares them next to the builders,
``program_lint`` checks what each program dispatches when it runs eagerly,
``mutations`` holds seeded violations the checker must catch, and ``check``
is the command: ``python -m repro_torch.analysis.check``.

Only the registry is re-exported here; the checker imports the serving
stack, so it stays a submodule import.
"""
from repro_torch.analysis.contracts import (
    ExecutableContract,
    all_contracts,
    assert_compile_contract,
    contract_for,
    register_contract,
)

__all__ = [
    "ExecutableContract",
    "all_contracts",
    "assert_compile_contract",
    "contract_for",
    "register_contract",
]
