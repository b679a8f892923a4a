"""The command line: main.py (every mode of the pipeline), offline_eval.py
(the offline evaluator) and bench.py (the measuring tool)."""
