from .sharding import (distributed_init, make_mesh, render_sharded,  # noqa: F401
                       shard_train_step, ShardedTrainer)
from .stats import (sharded_colours_variance,  # noqa: F401
                    sharded_prune_list)
