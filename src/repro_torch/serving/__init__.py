"""Serving the LM tenant (counterpart of ``repro/serving``): batched
prefill + decode (``decode.generate``) and the RAG pipeline over the baton
engine's retrieval (``rag.RAGSystem``)."""
