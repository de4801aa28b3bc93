"""Huffman tables: the K.2 builder and the fixed K.3 tables."""
