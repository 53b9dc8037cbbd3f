// C ABI of the shm-arena object store (object_store.cc). Shared by the
// ctypes loader docs, the chaos driver, and any future native client so a
// signature change is a compile error, not a silent ABI mismatch.
#pragma once

#include <cstdint>

extern "C" {
void* rt_store_open(const char* path, uint64_t capacity, uint64_t table_size,
                    int create);
void rt_store_close(void* handle);
uint64_t rt_store_create(void* handle, const uint8_t* id, uint64_t size,
                         int* err);
int rt_store_seal(void* handle, const uint8_t* id);
uint64_t rt_store_get(void* handle, const uint8_t* id, uint64_t* size);
int rt_store_contains(void* handle, const uint8_t* id);
int rt_store_release(void* handle, const uint8_t* id);
int rt_store_abort(void* handle, const uint8_t* id);
int rt_store_delete(void* handle, const uint8_t* id);
uint64_t rt_store_used_bytes(void* handle);
uint64_t rt_store_num_objects(void* handle);
void* rt_store_base(void* handle);
uint64_t rt_store_capacity(void* handle);
int rt_store_lru_victim(void* handle, uint8_t* out_id);
uint64_t rt_store_prefault(void* handle, uint64_t max_bytes);
}
