from .replay import SyntheticFlowGen
