"""Plain references of the models, which the tests hold the port against:
written from the papers and the configuration, importing nothing of the
port."""
