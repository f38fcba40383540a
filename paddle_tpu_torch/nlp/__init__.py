"""NLP model families."""
