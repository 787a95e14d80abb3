"""Train's storage layer (``storage.py``), which the runtime's object
spilling and runtime envs use. The trainer, sessions and checkpoints
come with ROADMAP.md section A6."""
