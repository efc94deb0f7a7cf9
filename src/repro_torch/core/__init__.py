"""Core of the port: engine, typed configs, result type and plan API."""
from repro_torch.core.api import pad_to_multiple
from repro_torch.core.configs import (ChebyshevConfig, ExactConfig,
                                      SLQConfig, config_from_dict,
                                      config_to_dict, from_jax_config)
from repro_torch.core.engine import EngineConfig
from repro_torch.core.mesh import Mesh, make_mesh, run_ranks
from repro_torch.core.plan import LogdetPlan, clear_plan_cache, plan
from repro_torch.core.result import Diagnostics, LogdetResult

__all__ = ["plan", "LogdetPlan", "ExactConfig", "ChebyshevConfig",
           "SLQConfig", "EngineConfig", "Mesh", "make_mesh", "run_ranks",
           "LogdetResult", "Diagnostics", "pad_to_multiple",
           "config_to_dict", "config_from_dict", "from_jax_config",
           "clear_plan_cache"]
