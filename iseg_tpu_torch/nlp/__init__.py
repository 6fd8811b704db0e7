"""NLP side-module: the Gemma causal LM (``nlp.gemma``)."""
