"""The LM stack of the port: layers, attention, the composable model
(dense and MoE MLPs, attention and Mamba-2 mixers, RoPE and M-RoPE, the
token, frame and patch front ends), its train and serve steps."""
