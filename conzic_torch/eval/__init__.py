"""Host-side caption evaluators: diversity, sentence sentiment, POS."""
