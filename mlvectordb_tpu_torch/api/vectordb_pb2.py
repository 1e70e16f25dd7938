# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: vectordb.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0evectordb.proto\x12\nmlvectordb\";\n\x06Vector\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0e\n\x06values\x18\x02 \x03(\x02\x12\x15\n\rmetadata_json\x18\x03 \x01(\t\"G\n\rUpsertRequest\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12#\n\x07vectors\x18\x02 \x03(\x0b\x32\x12.mlvectordb.Vector\"\x1d\n\x0eUpsertResponse\x12\x0b\n\x03ids\x18\x01 \x03(\t\"u\n\rSearchRequest\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\r\n\x05query\x18\x02 \x03(\x02\x12\r\n\x05top_k\x18\x03 \x01(\r\x12\x0e\n\x06metric\x18\x04 \x01(\t\x12\x13\n\x0b\x66ilter_json\x18\x05 \x01(\t\x12\x0e\n\x06nprobe\x18\x06 \x01(\r\"M\n\tSearchHit\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0e\n\x06values\x18\x02 \x03(\x02\x12\x15\n\rmetadata_json\x18\x03 \x01(\t\x12\r\n\x05score\x18\x04 \x01(\x02\"5\n\x0eSearchResponse\x12#\n\x04hits\x18\x01 \x03(\x0b\x32\x15.mlvectordb.SearchHit\"T\n\x12\x42\x61tchSearchRequest\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12+\n\x08requests\x18\x02 \x03(\x0b\x32\x19.mlvectordb.SearchRequest\"D\n\x13\x42\x61tchSearchResponse\x12-\n\tresponses\x18\x01 \x03(\x0b\x32\x1a.mlvectordb.SearchResponse\"/\n\rDeleteRequest\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\x0b\n\x03ids\x18\x02 \x03(\t\"%\n\x0e\x44\x65leteResponse\x12\x13\n\x0bremoved_ids\x18\x01 \x03(\t\"\x13\n\x11NamespacesRequest\"(\n\x12NamespacesResponse\x12\x12\n\nnamespaces\x18\x01 \x03(\t\"\r\n\x0bInfoRequest\"!\n\x0cInfoResponse\x12\x11\n\tinfo_json\x18\x01 \x01(\t\"\x1d\n\rHealthRequest\x12\x0c\n\x04\x64\x65\x65p\x18\x01 \x01(\x08\"5\n\x0eHealthResponse\x12\x0e\n\x06status\x18\x01 \x01(\t\x12\x13\n\x0breport_json\x18\x02 \x01(\t2\xed\x03\n\x08VectorDB\x12?\n\x06Upsert\x12\x19.mlvectordb.UpsertRequest\x1a\x1a.mlvectordb.UpsertResponse\x12?\n\x06Search\x12\x19.mlvectordb.SearchRequest\x1a\x1a.mlvectordb.SearchResponse\x12N\n\x0b\x42\x61tchSearch\x12\x1e.mlvectordb.BatchSearchRequest\x1a\x1f.mlvectordb.BatchSearchResponse\x12?\n\x06\x44\x65lete\x12\x19.mlvectordb.DeleteRequest\x1a\x1a.mlvectordb.DeleteResponse\x12O\n\x0eListNamespaces\x12\x1d.mlvectordb.NamespacesRequest\x1a\x1e.mlvectordb.NamespacesResponse\x12<\n\x07GetInfo\x12\x17.mlvectordb.InfoRequest\x1a\x18.mlvectordb.InfoResponse\x12?\n\x06Health\x12\x19.mlvectordb.HealthRequest\x1a\x1a.mlvectordb.HealthResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'vectordb_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _VECTOR._serialized_start=30
  _VECTOR._serialized_end=89
  _UPSERTREQUEST._serialized_start=91
  _UPSERTREQUEST._serialized_end=162
  _UPSERTRESPONSE._serialized_start=164
  _UPSERTRESPONSE._serialized_end=193
  _SEARCHREQUEST._serialized_start=195
  _SEARCHREQUEST._serialized_end=312
  _SEARCHHIT._serialized_start=314
  _SEARCHHIT._serialized_end=391
  _SEARCHRESPONSE._serialized_start=393
  _SEARCHRESPONSE._serialized_end=446
  _BATCHSEARCHREQUEST._serialized_start=448
  _BATCHSEARCHREQUEST._serialized_end=532
  _BATCHSEARCHRESPONSE._serialized_start=534
  _BATCHSEARCHRESPONSE._serialized_end=602
  _DELETEREQUEST._serialized_start=604
  _DELETEREQUEST._serialized_end=651
  _DELETERESPONSE._serialized_start=653
  _DELETERESPONSE._serialized_end=690
  _NAMESPACESREQUEST._serialized_start=692
  _NAMESPACESREQUEST._serialized_end=711
  _NAMESPACESRESPONSE._serialized_start=713
  _NAMESPACESRESPONSE._serialized_end=753
  _INFOREQUEST._serialized_start=755
  _INFOREQUEST._serialized_end=768
  _INFORESPONSE._serialized_start=770
  _INFORESPONSE._serialized_end=803
  _HEALTHREQUEST._serialized_start=805
  _HEALTHREQUEST._serialized_end=834
  _HEALTHRESPONSE._serialized_start=836
  _HEALTHRESPONSE._serialized_end=889
  _VECTORDB._serialized_start=892
  _VECTORDB._serialized_end=1385
# @@protoc_insertion_point(module_scope)
