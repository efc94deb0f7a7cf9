"""Core of the port: engine, baselines, cost model, typed configs, result
type and plan API, and the JAX package's deprecated string API
(``slogdet``, ``logdet``, ``logdet_batched``: shims over cached plans)."""
from repro_torch.core.api import (METHODS, logdet, logdet_batched,
                                  pad_to_multiple, slogdet)
from repro_torch.core.calibration import Calibration, load_calibration
from repro_torch.core.condense import (combine_slogdet, condense_steps,
                                       slogdet_condense,
                                       slogdet_condense_staged)
from repro_torch.core.configs import (ChebyshevConfig, ExactConfig,
                                      SLQConfig, config_from_dict,
                                      config_to_dict, from_jax_config)
from repro_torch.core.engine import EngineConfig
from repro_torch.core.gaussian import parallel_slogdet_ge, slogdet_ge
from repro_torch.core.mesh import Mesh, make_mesh, run_ranks
from repro_torch.core.plan import (LogdetPlan, ProblemSpec,
                                   clear_plan_cache, plan, select_method,
                                   select_route, spec_of)
from repro_torch.core.result import Diagnostics, LogdetResult
from repro_torch.core.scalapack import parallel_slogdet_lu

__all__ = ["slogdet", "logdet", "logdet_batched", "METHODS",
           "plan", "LogdetPlan", "ProblemSpec", "spec_of", "select_method",
           "select_route", "Calibration", "load_calibration", "ExactConfig",
           "ChebyshevConfig", "SLQConfig", "EngineConfig", "Mesh",
           "make_mesh", "run_ranks", "LogdetResult", "Diagnostics",
           "pad_to_multiple", "config_to_dict", "config_from_dict",
           "from_jax_config", "clear_plan_cache", "slogdet_condense",
           "slogdet_condense_staged", "condense_steps", "combine_slogdet",
           "slogdet_ge", "parallel_slogdet_ge", "parallel_slogdet_lu"]
