from repro_torch.sharding.ctx import ShardCtx, use_sharding, shard_act, current_ctx
from repro_torch.sharding.rules import param_specs, batch_specs, cache_specs
