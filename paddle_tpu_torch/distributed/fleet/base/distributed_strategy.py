"""DistributedStrategy (counterpart of
paddle_tpu/distributed/fleet/base/distributed_strategy.py).

A plain serialisable config object, as in the reference: every toggle a
bool, every ``*_configs`` a dict, under the reference's names and
defaults, so scripts written against it assign the same fields. `fleet`
reads ``hybrid_configs``; the engines take ZeRO and the pipeline from
their own arguments.
"""

from __future__ import annotations

import copy
import json


_DEFAULTS = {
    # toggles (distributed_strategy.proto:159-195)
    "amp": False,
    "recompute": False,
    "sharding": False,
    "pipeline": False,
    "tensor_parallel": False,
    "dgc": False,
    "localsgd": False,
    "adaptive_localsgd": False,
    "gradient_merge": False,
    "lars": False,
    "lamb": False,
    "fp16_allreduce": False,
    "a_sync": False,
    "asp": False,
    "heter_ccl_mode": False,
    "elastic": False,
    "auto": False,
    "semi_auto": False,
    "without_graph_optimization": True,
    "fuse_all_reduce_ops": True,
    "fuse_grad_size_in_MB": 32,
    "nccl_comm_num": 1,
    "sync_nccl_allreduce": True,
    "use_hierarchical_allreduce": False,
    "cudnn_exhaustive_search": False,
    "find_unused_parameters": False,
}

_CONFIG_DEFAULTS = {
    "amp_configs": {
        "init_loss_scaling": 32768.0,
        "incr_every_n_steps": 1000,
        "decr_every_n_nan_or_inf": 2,
        "incr_ratio": 2.0,
        "decr_ratio": 0.5,
        "use_dynamic_loss_scaling": True,
        "custom_white_list": [],
        "custom_black_list": [],
        "use_pure_fp16": False,
        "use_fp16_guard": True,
        "dtype": "bfloat16",
    },
    "recompute_configs": {
        "checkpoints": [],
        "enable_offload": False,
        "checkpoint_shape": [],
    },
    "sharding_configs": {
        # ref proto ShardingConfig (:32-45)
        "sharding_segment_strategy": "segment_broadcast_MB",
        "segment_broadcast_MB": 32.0,
        "sharding_degree": 8,
        "mp_degree": 1,
        "dp_degree": 1,
        "pp_degree": 1,
        "stage": 2,
        "offload": False,
        "gradient_merge_acc_step": 1,
        "optimize_offload": False,
    },
    "pipeline_configs": {
        # ref proto PipelineConfig (:148-152)
        "micro_batch_size": 1,
        "accumulate_steps": 1,
        "schedule_mode": "1F1B",
        "p2p_cache_shape": True,
    },
    "tensor_parallel_configs": {
        "tensor_parallel_degree": 1,
        "tensor_init_seed": -1,
    },
    "hybrid_configs": {
        "dp_degree": -1,
        "mp_degree": 1,
        "pp_degree": 1,
        "sharding_degree": 1,
        "sep_degree": 1,
    },
    "gradient_merge_configs": {"k_steps": 1, "avg": True},
    "localsgd_configs": {"k_steps": 1, "begin_step": 1},
    "adaptive_localsgd_configs": {"init_k_steps": 1, "begin_step": 1},
    "dgc_configs": {"rampup_begin_step": 0, "rampup_step": 1,
                    "sparsity": [0.999]},
    "lars_configs": {"lars_coeff": 0.001, "lars_weight_decay": 0.0005,
                     "epsilon": 0.0, "exclude_from_weight_decay": []},
    "lamb_configs": {"lamb_weight_decay": 0.01,
                     "exclude_from_weight_decay": []},
    "a_sync_configs": {"k_steps": -1, "max_merge_var_num": 1,
                       "send_queue_size": 16,
                       "independent_recv_thread": False,
                       "min_send_grad_num_before_recv": 1,
                       "thread_pool_size": 1, "send_wait_times": 1,
                       "runtime_split_send_recv": False, "launch_barrier": True,
                       "heter_worker_device_guard": "cpu", "lr_decay_steps": 10,
                       "use_ps_gpu": 0, "use_gpu_graph": 0},
    "elastic_configs": {},
}


class DistributedStrategy:
    def __init__(self):
        self._flags = copy.deepcopy(_DEFAULTS)
        self._configs = copy.deepcopy(_CONFIG_DEFAULTS)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self._flags:
            return self._flags[name]
        if name in self._configs:
            return self._configs[name]
        raise AttributeError(f"DistributedStrategy has no field {name!r}")

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        if name in _DEFAULTS:
            self._flags[name] = value
        elif name in _CONFIG_DEFAULTS:
            cfg = copy.deepcopy(_CONFIG_DEFAULTS[name])
            cfg.update(value)
            self._configs[name] = cfg
        else:
            object.__setattr__(self, name, value)

    def to_dict(self):
        return {"flags": copy.deepcopy(self._flags),
                "configs": copy.deepcopy(self._configs)}

    def save_to_prototxt(self, output):
        with open(output, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def load_from_prototxt(self, pb_file):
        with open(pb_file) as f:
            d = json.load(f)
        self._flags.update(d.get("flags", {}))
        for k, v in d.get("configs", {}).items():
            self._configs[k].update(v)

    def __repr__(self):
        on = [k for k, v in self._flags.items() if v is True]
        return f"DistributedStrategy(enabled={on})"
