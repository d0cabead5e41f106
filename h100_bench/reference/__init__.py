"""The plain reference: float32 Qwen3 (``qwen3.py``), the prompt format
and byte tokenizer (``prompt.py``) and the schema check (``schema.py``).
It imports nothing of the program."""
