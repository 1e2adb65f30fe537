"""helm_tpu — TFHE circuit evaluation in JAX (HELM-capable framework).

See DESIGN.md for architecture and SURVEY.md for the reference contract.

Top-level API (lazy imports — `import helm_tpu` stays cheap and does not
initialize jax):

    helm_tpu.read_verilog_file(path, is_arith)   netlist frontend
    helm_tpu.Circuit                             scheduler + plaintext oracle
    helm_tpu.BooleanEngine                       gates / LUT modes
    helm_tpu.ArithEngine                         radix-integer mode
    helm_tpu.params                              parameter sets (ALL_PARAMS)

A full walkthrough lives in examples/library_api.py.
"""

__version__ = "0.1.0"

__all__ = [
    "ArithEngine",
    "BooleanEngine",
    "Circuit",
    "params",
    "read_verilog_file",
]


def __getattr__(name):
    if name == "BooleanEngine":
        from .engines.boolean import BooleanEngine

        return BooleanEngine
    if name == "ArithEngine":
        from .engines.arith import ArithEngine

        return ArithEngine
    if name == "Circuit":
        from .circuit.graph import Circuit

        return Circuit
    if name == "read_verilog_file":
        from .circuit.verilog import read_verilog_file

        return read_verilog_file
    if name == "params":
        # importlib, not `from . import params`: the from-import form
        # re-enters this __getattr__ while the submodule attribute is
        # still unset and recurses
        import importlib

        return importlib.import_module(".params", __name__)
    raise AttributeError(f"module 'helm_tpu' has no attribute {name!r}")
