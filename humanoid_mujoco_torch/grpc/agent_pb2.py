# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: agent.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0b\x61gent.proto\x12\x13humanoid_mujoco_tpu\"\x07\n\x05\x45mpty\"b\n\x0bInitRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0f\n\x07planner\x18\x02 \x01(\t\x12\x0f\n\x07horizon\x18\x03 \x01(\x05\x12\x0f\n\x07nsample\x18\x04 \x01(\x05\x12\x0f\n\x07plan_dt\x18\x05 \x01(\x01\"1\n\x05State\x12\x0c\n\x04qpos\x18\x01 \x03(\x01\x12\x0c\n\x04qvel\x18\x02 \x03(\x01\x12\x0c\n\x04time\x18\x03 \x01(\x01\"(\n\x12PlannerStepRequest\x12\x12\n\niterations\x18\x01 \x01(\x05\"*\n\x13PlannerStepResponse\x12\x13\n\x0b\x62\x65st_return\x18\x01 \x01(\x01\"T\n\x10GetActionRequest\x12\x0c\n\x04time\x18\x01 \x01(\x01\x12\x1a\n\x12\x61veraging_duration\x18\x02 \x01(\x01\x12\x16\n\x0enominal_action\x18\x03 \x01(\x08\"\x18\n\x06\x41\x63tion\x12\x0e\n\x06\x61\x63tion\x18\x01 \x03(\x01\"\x8c\x01\n\x0eTaskParameters\x12G\n\nparameters\x18\x01 \x03(\x0b\x32\x33.humanoid_mujoco_tpu.TaskParameters.ParametersEntry\x1a\x31\n\x0fParametersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x02\x38\x01\"}\n\x0b\x43ostWeights\x12>\n\x07weights\x18\x01 \x03(\x0b\x32-.humanoid_mujoco_tpu.CostWeights.WeightsEntry\x1a.\n\x0cWeightsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x02\x38\x01\"\xe7\x01\n\nCostValues\x12;\n\x06values\x18\x01 \x03(\x0b\x32+.humanoid_mujoco_tpu.CostValues.ValuesEntry\x12=\n\x07weights\x18\x02 \x03(\x0b\x32,.humanoid_mujoco_tpu.CostValues.WeightsEntry\x1a-\n\x0bValuesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x02\x38\x01\x1a.\n\x0cWeightsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x02\x38\x01\"\x1e\n\tResiduals\x12\x11\n\tresiduals\x18\x01 \x03(\x01\"\x14\n\x04Mode\x12\x0c\n\x04mode\x18\x01 \x01(\t\"0\n\x05Mocap\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0b\n\x03pos\x18\x02 \x03(\x01\x12\x0c\n\x04quat\x18\x03 \x03(\x01\"}\n\nTrajectory\x12\x0f\n\x07horizon\x18\x01 \x01(\x05\x12\n\n\x02nq\x18\x02 \x01(\x05\x12\n\n\x02nv\x18\x03 \x01(\x05\x12\n\n\x02nu\x18\x04 \x01(\x05\x12\r\n\x05times\x18\x05 \x03(\x01\x12\x0c\n\x04qpos\x18\x06 \x03(\x01\x12\x0c\n\x04qvel\x18\x07 \x03(\x01\x12\x0f\n\x07\x61\x63tions\x18\x08 \x03(\x01\"\xcc\x01\n\x08\x41nything\x12\x32\n\x05model\x18\x01 \x03(\x0b\x32#.humanoid_mujoco_tpu.Anything.Entry\x12\x32\n\x05state\x18\x02 \x03(\x0b\x32#.humanoid_mujoco_tpu.Anything.Entry\x12\x31\n\x04task\x18\x03 \x03(\x0b\x32#.humanoid_mujoco_tpu.Anything.Entry\x1a%\n\x05\x45ntry\x12\r\n\x05\x66ield\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x03(\x01\x32\xb8\t\n\x05\x41gent\x12\x44\n\x04Init\x12 .humanoid_mujoco_tpu.InitRequest\x1a\x1a.humanoid_mujoco_tpu.Empty\x12\x42\n\x08GetState\x12\x1a.humanoid_mujoco_tpu.Empty\x1a\x1a.humanoid_mujoco_tpu.State\x12\x42\n\x08SetState\x12\x1a.humanoid_mujoco_tpu.State\x1a\x1a.humanoid_mujoco_tpu.Empty\x12`\n\x0bPlannerStep\x12\'.humanoid_mujoco_tpu.PlannerStepRequest\x1a(.humanoid_mujoco_tpu.PlannerStepResponse\x12O\n\tGetAction\x12%.humanoid_mujoco_tpu.GetActionRequest\x1a\x1b.humanoid_mujoco_tpu.Action\x12?\n\x04Step\x12\x1a.humanoid_mujoco_tpu.Empty\x1a\x1b.humanoid_mujoco_tpu.Action\x12?\n\x05Reset\x12\x1a.humanoid_mujoco_tpu.Empty\x1a\x1a.humanoid_mujoco_tpu.Empty\x12T\n\x11SetTaskParameters\x12#.humanoid_mujoco_tpu.TaskParameters\x1a\x1a.humanoid_mujoco_tpu.Empty\x12N\n\x0eSetCostWeights\x12 .humanoid_mujoco_tpu.CostWeights\x1a\x1a.humanoid_mujoco_tpu.Empty\x12V\n\x17GetCostValuesAndWeights\x12\x1a.humanoid_mujoco_tpu.Empty\x1a\x1f.humanoid_mujoco_tpu.CostValues\x12J\n\x0cGetResiduals\x12\x1a.humanoid_mujoco_tpu.Empty\x1a\x1e.humanoid_mujoco_tpu.Residuals\x12@\n\x07SetMode\x12\x19.humanoid_mujoco_tpu.Mode\x1a\x1a.humanoid_mujoco_tpu.Empty\x12@\n\x07GetMode\x12\x1a.humanoid_mujoco_tpu.Empty\x1a\x19.humanoid_mujoco_tpu.Mode\x12\x42\n\x08SetMocap\x12\x1a.humanoid_mujoco_tpu.Mocap\x1a\x1a.humanoid_mujoco_tpu.Empty\x12P\n\x11GetBestTrajectory\x12\x1a.humanoid_mujoco_tpu.Empty\x1a\x1f.humanoid_mujoco_tpu.Trajectory\x12H\n\x0bSetAnything\x12\x1d.humanoid_mujoco_tpu.Anything\x1a\x1a.humanoid_mujoco_tpu.Emptyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'agent_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TASKPARAMETERS_PARAMETERSENTRY._options = None
  _TASKPARAMETERS_PARAMETERSENTRY._serialized_options = b'8\001'
  _COSTWEIGHTS_WEIGHTSENTRY._options = None
  _COSTWEIGHTS_WEIGHTSENTRY._serialized_options = b'8\001'
  _COSTVALUES_VALUESENTRY._options = None
  _COSTVALUES_VALUESENTRY._serialized_options = b'8\001'
  _COSTVALUES_WEIGHTSENTRY._options = None
  _COSTVALUES_WEIGHTSENTRY._serialized_options = b'8\001'
  _EMPTY._serialized_start=36
  _EMPTY._serialized_end=43
  _INITREQUEST._serialized_start=45
  _INITREQUEST._serialized_end=143
  _STATE._serialized_start=145
  _STATE._serialized_end=194
  _PLANNERSTEPREQUEST._serialized_start=196
  _PLANNERSTEPREQUEST._serialized_end=236
  _PLANNERSTEPRESPONSE._serialized_start=238
  _PLANNERSTEPRESPONSE._serialized_end=280
  _GETACTIONREQUEST._serialized_start=282
  _GETACTIONREQUEST._serialized_end=366
  _ACTION._serialized_start=368
  _ACTION._serialized_end=392
  _TASKPARAMETERS._serialized_start=395
  _TASKPARAMETERS._serialized_end=535
  _TASKPARAMETERS_PARAMETERSENTRY._serialized_start=486
  _TASKPARAMETERS_PARAMETERSENTRY._serialized_end=535
  _COSTWEIGHTS._serialized_start=537
  _COSTWEIGHTS._serialized_end=662
  _COSTWEIGHTS_WEIGHTSENTRY._serialized_start=616
  _COSTWEIGHTS_WEIGHTSENTRY._serialized_end=662
  _COSTVALUES._serialized_start=665
  _COSTVALUES._serialized_end=896
  _COSTVALUES_VALUESENTRY._serialized_start=803
  _COSTVALUES_VALUESENTRY._serialized_end=848
  _COSTVALUES_WEIGHTSENTRY._serialized_start=616
  _COSTVALUES_WEIGHTSENTRY._serialized_end=662
  _RESIDUALS._serialized_start=898
  _RESIDUALS._serialized_end=928
  _MODE._serialized_start=930
  _MODE._serialized_end=950
  _MOCAP._serialized_start=952
  _MOCAP._serialized_end=1000
  _TRAJECTORY._serialized_start=1002
  _TRAJECTORY._serialized_end=1127
  _ANYTHING._serialized_start=1130
  _ANYTHING._serialized_end=1334
  _ANYTHING_ENTRY._serialized_start=1297
  _ANYTHING_ENTRY._serialized_end=1334
  _AGENT._serialized_start=1337
  _AGENT._serialized_end=2545
# @@protoc_insertion_point(module_scope)
