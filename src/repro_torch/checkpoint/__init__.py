"""Checkpoints of the port: ``repro``'s files, topology-free, restorable
under any layout and any number of ranks (counterpart of
``repro.checkpoint``)."""
from .layouts import (CheckpointLayout, Zero1CheckpointLayout,
                      Zero3CheckpointLayout, REPLICATED,
                      concat_flat_order, split_flat_order)
from .store import (AsyncCheckpointer, CheckpointCorruptError,
                    committed_steps, keep_last_k, latest_step,
                    latest_verified_step, load_canonical, peek_manifest,
                    restore_checkpoint, save_checkpoint, step_dir,
                    verify_checkpoint)
