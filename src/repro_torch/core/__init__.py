"""The baton engine, its beam search and the index build, in PyTorch."""
