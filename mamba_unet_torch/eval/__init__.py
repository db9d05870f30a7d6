"""Evaluation: host-side (numpy/scipy) metrics, slice and sliding-window
3-D volume inference, and the Mamba-LM loglikelihood evaluator."""
