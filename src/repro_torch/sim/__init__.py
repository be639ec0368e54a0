"""repro_torch.sim — fault and client-heterogeneity scenarios for WSSL, the
twin of ``repro.sim``.

* faults.py   — ScenarioParams / FaultPlan and the transforms that compose
                with the selection mask: dropout, stragglers, label flip,
                gradient noise, sign flip, scaled updates, the adaptive
                (ALIE) attack and per-hop faults, with every draw
                injectable.
* registry.py — the named presets, the JAX package's.

The Scenario dataclass lives in ``repro_torch.config``; the data partition
hook in ``repro_torch.data.partition.partition_for_scenario``.
"""

from repro_torch.sim.faults import (FaultDraws, FaultPlan,  # noqa: F401
                                    ScenarioParams, adaptive_scale_updates,
                                    add_gradient_noise, apply_sign_flip,
                                    client_latencies, corrupt_client_grads,
                                    corrupt_labels, label_shift,
                                    sample_fault_plan, scale_client_updates,
                                    scenario_params)
from repro_torch.sim.registry import (SCENARIOS, get_scenario,  # noqa: F401
                                      list_scenarios, register_scenario)
