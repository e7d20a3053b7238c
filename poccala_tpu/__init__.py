"""poccala_tpu — an accelerator-native (JAX/XLA) GMM-HMM ASR framework.

A from-scratch rebuild of the capability surface of the reference Python
system Byshx/Poccala (surveyed in SURVEY.md): MFCC+VAD feature frontend,
diagonal-GMM acoustic scoring, log-space HMM forward/backward (Baum-Welch)
with flat-start and Viterbi-realignment training schemes, k-means/SMEM
mixture management, and Viterbi/beam decoding over a Mandarin pinyin
pronunciation lexicon — all as batched, jit-compiled scan/matmul programs
sharded over device meshes (one or four GPUs).

Design stance (SURVEY.md §7): the reference's object-per-unit,
file-per-parameter design inverts on an accelerator into one batched *senone bank*
pytree; per-unit Python loops become batched axes; file-based accumulator
reduction becomes `psum` over the device mesh.
"""

__version__ = "0.1.0"

from poccala_tpu.config import Config, FrontendConfig, ModelConfig, TrainConfig

__all__ = [
    "Config",
    "FrontendConfig",
    "ModelConfig",
    "TrainConfig",
    "__version__",
]
