"""Native (C++) host code of the port: the word segmenter."""
