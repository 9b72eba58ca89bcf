# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: kubeflow_tpu/serving/predict.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\"kubeflow_tpu/serving/predict.proto\x12\x14kubeflow_tpu.serving\"4\n\x06Tensor\x12\r\n\x05shape\x18\x01 \x03(\x03\x12\r\n\x05\x64type\x18\x02 \x01(\t\x12\x0c\n\x04\x64\x61ta\x18\x03 \x01(\x0c\"c\n\x0ePredictRequest\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\x03\x12,\n\x06inputs\x18\x03 \x01(\x0b\x32\x1c.kubeflow_tpu.serving.Tensor\"W\n\x0fPredictResponse\x12-\n\x07outputs\x18\x01 \x01(\x0b\x32\x1c.kubeflow_tpu.serving.Tensor\x12\x15\n\rmodel_version\x18\x02 \x01(\x03\"(\n\x12ModelStatusRequest\x12\x12\n\nmodel_name\x18\x01 \x01(\t\"4\n\x12ModelVersionStatus\x12\x0f\n\x07version\x18\x01 \x01(\x03\x12\r\n\x05state\x18\x02 \x01(\t\"]\n\x13ModelStatusResponse\x12\x46\n\x14model_version_status\x18\x01 \x03(\x0b\x32(.kubeflow_tpu.serving.ModelVersionStatus\"\x13\n\x11ListModelsRequest\"$\n\x12ListModelsResponse\x12\x0e\n\x06models\x18\x01 \x03(\t\"\xab\x02\n\x0fGenerateRequest\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\x03\x12,\n\x06prompt\x18\x03 \x01(\x0b\x32\x1c.kubeflow_tpu.serving.Tensor\x12\x10\n\x08true_len\x18\x04 \x01(\x03\x12\x16\n\x0emax_new_tokens\x18\x05 \x01(\x03\x12\x13\n\x0btemperature\x18\x06 \x01(\x02\x12\x0c\n\x04seed\x18\x07 \x01(\x03\x12\r\n\x05top_k\x18\x08 \x01(\x03\x12\r\n\x05top_p\x18\t \x01(\x02\x12\x13\n\x06\x65os_id\x18\n \x01(\x03H\x00\x88\x01\x01\x12\x12\n\nprefix_len\x18\x0b \x01(\x03\x12\x13\n\x0bspeculative\x18\x0c \x01(\x08\x12\x11\n\tdraft_len\x18\r \x01(\x03\x42\t\n\x07_eos_id\"\x85\x01\n\x10SpeculativeStats\x12\r\n\x05\x64raft\x18\x01 \x01(\t\x12\x11\n\tdraft_len\x18\x02 \x01(\x03\x12\x0e\n\x06rounds\x18\x03 \x01(\x03\x12\x14\n\x0c\x64raft_tokens\x18\x04 \x01(\x03\x12\x10\n\x08\x61\x63\x63\x65pted\x18\x05 \x01(\x03\x12\x17\n\x0f\x61\x63\x63\x65ptance_rate\x18\x06 \x01(\x02\"\xa9\x01\n\x10GenerateResponse\x12,\n\x06tokens\x18\x01 \x01(\x0b\x32\x1c.kubeflow_tpu.serving.Tensor\x12\x15\n\rmodel_version\x18\x02 \x01(\x03\x12@\n\x0bspeculative\x18\x03 \x01(\x0b\x32&.kubeflow_tpu.serving.SpeculativeStatsH\x00\x88\x01\x01\x42\x0e\n\x0c_speculative\"D\n\rGenerateChunk\x12\x0e\n\x06tokens\x18\x01 \x03(\x05\x12\x0c\n\x04\x64one\x18\x02 \x01(\x08\x12\x15\n\rmodel_version\x18\x03 \x01(\x03\x32\xee\x03\n\x11PredictionService\x12V\n\x07Predict\x12$.kubeflow_tpu.serving.PredictRequest\x1a%.kubeflow_tpu.serving.PredictResponse\x12\x65\n\x0eGetModelStatus\x12(.kubeflow_tpu.serving.ModelStatusRequest\x1a).kubeflow_tpu.serving.ModelStatusResponse\x12_\n\nListModels\x12\'.kubeflow_tpu.serving.ListModelsRequest\x1a(.kubeflow_tpu.serving.ListModelsResponse\x12Y\n\x08Generate\x12%.kubeflow_tpu.serving.GenerateRequest\x1a&.kubeflow_tpu.serving.GenerateResponse\x12^\n\x0eGenerateStream\x12%.kubeflow_tpu.serving.GenerateRequest\x1a#.kubeflow_tpu.serving.GenerateChunk0\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'kubeflow_tpu.serving.predict_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TENSOR._serialized_start=60
  _TENSOR._serialized_end=112
  _PREDICTREQUEST._serialized_start=114
  _PREDICTREQUEST._serialized_end=213
  _PREDICTRESPONSE._serialized_start=215
  _PREDICTRESPONSE._serialized_end=302
  _MODELSTATUSREQUEST._serialized_start=304
  _MODELSTATUSREQUEST._serialized_end=344
  _MODELVERSIONSTATUS._serialized_start=346
  _MODELVERSIONSTATUS._serialized_end=398
  _MODELSTATUSRESPONSE._serialized_start=400
  _MODELSTATUSRESPONSE._serialized_end=493
  _LISTMODELSREQUEST._serialized_start=495
  _LISTMODELSREQUEST._serialized_end=514
  _LISTMODELSRESPONSE._serialized_start=516
  _LISTMODELSRESPONSE._serialized_end=552
  _GENERATEREQUEST._serialized_start=555
  _GENERATEREQUEST._serialized_end=854
  _SPECULATIVESTATS._serialized_start=857
  _SPECULATIVESTATS._serialized_end=990
  _GENERATERESPONSE._serialized_start=993
  _GENERATERESPONSE._serialized_end=1162
  _GENERATECHUNK._serialized_start=1164
  _GENERATECHUNK._serialized_end=1232
  _PREDICTIONSERVICE._serialized_start=1235
  _PREDICTIONSERVICE._serialized_end=1729
# @@protoc_insertion_point(module_scope)
