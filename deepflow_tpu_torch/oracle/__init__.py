"""The exact NumPy/dict rollup oracle (port copy of deepflow_tpu/oracle)."""

from .numpy_oracle import OracleDoc, oracle_l4_rollup, oracle_l7_rollup

__all__ = ["OracleDoc", "oracle_l4_rollup", "oracle_l7_rollup"]
