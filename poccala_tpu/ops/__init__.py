"""Compute ops tier: batched, jit-compiled device kernels.

Each module replaces one of the reference's scalar-Python hot loops
(SURVEY.md §2 "native components"): ``frontend`` (MFCC/STFT), ``vad``,
``gmm_score`` (GMM log-likelihood), ``hmm`` (forward/backward/Viterbi),
``kmeans`` and ``em`` (GMM estimation).
"""
